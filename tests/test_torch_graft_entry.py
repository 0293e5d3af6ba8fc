"""The port's graft entry points (deciphon_tpu_torch/graft_entry.py) on
the CPU: `entry("cpu")` against the reference's `__graft_entry__.entry()`
under jax.jit, bit for bit; `dryrun_multichip(n, "cpu")` for n 2 and 4
(n shards against one device inside, and its products against the
reference's engine="jax" Scanner on the same inputs, carried across as
arrays); and the bucket ledgers of a sharded scan, equal to one
device's.  Without a card, both entry points refuse their default
device."""

import numpy as np
import pytest
import torch

from deciphon_tpu_torch import graft_entry
from deciphon_tpu_torch.convert import (frame_profile_from_arrays,
                                        sequence_from_arrays)
from deciphon_tpu_torch.scan import pipeline as tp
from deciphon_tpu_torch.scan import scheduler as ts
from deciphon_tpu_torch.workload import pfam_subset, planted_read, random_bases

# One torch thread: the plain versions run thousands of small ops, and
# several test workers with a thread pool each starve one another.
torch.set_num_threads(1)


def same(a, b) -> bool:
    a, b = np.asarray(a), np.asarray(b)
    return a.dtype == b.dtype and a.shape == b.shape and np.array_equal(a, b)


def test_entry_bit_equal_to_reference():
    import jax

    import __graft_entry__ as ref

    fn, args = ref.entry()
    want = [np.asarray(o) for o in jax.jit(fn)(*args)]
    pfn, pargs = graft_entry.entry("cpu")
    assert len(pargs) == len(args) == 7
    assert all(t.device.type == "cpu" for t in pargs)
    for a, b in zip(args, pargs):
        assert same(np.asarray(a), b.numpy())
    got = [o.numpy() for o in pfn(*pargs)]
    assert [g.shape for g in got] == [(2, 2), (2, 2)]
    assert all(same(g, w) for g, w in zip(got, want))
    assert np.isfinite(got[0]).all() and np.isfinite(got[1]).all()


def test_entry_points_default_to_the_card():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device works")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        graft_entry.entry()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        graft_entry.dryrun_multichip(2)


@pytest.fixture(scope="module")
def jax_products(tmp_path_factory):
    """The reference's engine="jax" scan of the dry run's workload."""
    from deciphon_tpu.profile import FrameProfile
    from deciphon_tpu.scan import pipeline as ref_pipeline
    from deciphon_tpu.scan.sequence import Sequence

    profiles, seqs = pfam_subset()
    ref = ref_pipeline.Scanner([FrameProfile(**vars(p)) for p in profiles],
                               ref_pipeline.ScanConfig(engine="jax"))
    out = ref.run([Sequence.make(s.id, s.name, s.data) for s in seqs],
                  str(tmp_path_factory.mktemp("jax") / "prod"))
    assert ref.metrics.survivors > 0
    with open(out) as fp:
        return fp.read()


@pytest.mark.parametrize("n", [2, 4])
def test_dryrun_multichip_byte_identical_to_jax(jax_products, n):
    products, survivors = graft_entry.dryrun_multichip(n, "cpu")
    assert survivors > 0
    assert products == jax_products


@pytest.fixture(scope="module")
def planted():
    """tests/test_torch_scan_tiers.py's planted reads against its three
    profiles (K 40 and 9 pack, K 150 has a plain bucket)."""
    from deciphon_tpu_torch.profile import sample_profile
    from deciphon_tpu_torch.scan.sequence import Sequence

    profiles = [sample_profile(140, 40), sample_profile(250, 150),
                sample_profile(109, 9)]
    rng = np.random.default_rng(7)
    reads = [planted_read(rng, profiles[0], 300),
             planted_read(rng, profiles[1], 500, noise=0.01),
             random_bases(rng, 250),
             planted_read(rng, profiles[2], 480),
             random_bases(rng, 150)]
    seqs = [Sequence.make(i, f"r{i}", r) for i, r in enumerate(reads)]
    return ([frame_profile_from_arrays(**vars(p)) for p in profiles],
            [sequence_from_arrays(**vars(s)) for s in seqs])


@pytest.mark.parametrize("env", [{}, {"DECIPHON_CHAIN_SEG": "1"},
                                 {"DECIPHON_NO_CHAIN": "1"}],
                         ids=["gang", "seg", "classic"])
def test_shards_record_the_one_device_ledger(planted, tmp_path, monkeypatch,
                                             env):
    """Two shards record each launch once, under the one-device name (its
    n the wave's group count, not the count padded to the shards) with the
    one-device cells: these launches have one group, which the shards pad
    to two."""
    monkeypatch.setattr(ts.PairScorer, "CHAIN_MAX_BLK", 4)
    monkeypatch.setattr(ts.PairScorer, "NLB_FLOOR", 4)
    for k, v in {"DECIPHON_SYNC_DEBUG": "1", **env}.items():
        monkeypatch.setenv(k, v)
    profiles, seqs = planted
    got = {}
    for n in (1, 2):
        sc = tp.Scanner(profiles, tp.ScanConfig(device="cpu"),
                        scorer=lambda c: ts.BucketedPairScorer(
                            c, "cpu", devices=["cpu"] * n))
        with open(sc.run(seqs, str(tmp_path / f"n{n}"))) as fp:
            got[n] = (fp.read(), dict(sc.metrics.bucket_cells))
    assert got[1][1] and any("_n1_" in name for name in got[1][1])
    assert got[2] == got[1]
