"""Port parity end to end: the PyTorch Scanner on the CPU writes the same
products.tsv, byte for byte, as the JAX package's lax.scan engine."""

import os

import numpy as np
import pytest
import torch

from deciphon_tpu.profile import sample_profile
from deciphon_tpu.scan import pipeline as ref_pipeline
from deciphon_tpu.scan.sequence import Sequence
from deciphon_tpu_torch.convert import (costs_from_arrays,
                                        frame_profile_from_arrays,
                                        sequence_from_arrays)
from deciphon_tpu_torch.scan import pipeline as tp
from deciphon_tpu_torch.workload import pfam_ks, planted_read, random_bases

# One torch thread: the plain versions run thousands of small ops, and
# several test workers with a thread pool each starve one another.
torch.set_num_threads(1)


@pytest.fixture(scope="module")
def planted():
    """Three profiles (K = 40 and 9 pack side by side, K = 150 has a plain
    bucket) and four reads: two carry a planted domain, one is long enough
    for two K=9 windows.  Returns the reference's objects and the port's,
    carried across as arrays."""
    ref_profiles = [sample_profile(140, 40), sample_profile(250, 150),
                    sample_profile(109, 9)]
    profiles = [frame_profile_from_arrays(**vars(p)) for p in ref_profiles]
    rng = np.random.default_rng(7)
    reads = [planted_read(rng, profiles[0], 300),
             planted_read(rng, profiles[1], 500, noise=0.01),
             random_bases(rng, 250),
             planted_read(rng, profiles[2], 480)]
    ref_seqs = [Sequence.make(i, f"r{i}", r) for i, r in enumerate(reads)]
    seqs = [sequence_from_arrays(**vars(s)) for s in ref_seqs]
    return (ref_profiles, ref_seqs), (profiles, seqs)


def products(path):
    with open(path, "rb") as fp:
        return fp.read()


@pytest.mark.parametrize("mh,h3c", [(True, False), (False, True)])
@pytest.mark.parametrize("max_pairs,spec_depth", [(256, 64), (4, 1)])
def test_scan_products_byte_identical_to_jax(planted, tmp_path, mh, h3c,
                                             max_pairs, spec_depth):
    (ref_profiles, ref_seqs), (profiles, seqs) = planted
    flags = dict(multi_hits=mh, hmmer3_compat=h3c, max_pairs=max_pairs,
                 spec_depth=spec_depth)
    port = tp.Scanner(profiles, tp.ScanConfig(device="cpu", **flags))
    got = products(port.run(seqs, str(tmp_path / "torch")))
    ref = ref_pipeline.Scanner(ref_profiles,
                               ref_pipeline.ScanConfig(engine="jax", **flags))
    want = products(ref.run(ref_seqs, str(tmp_path / "jax")))
    assert port.metrics.survivors > 0
    assert port.metrics.survivors == ref.metrics.survivors
    assert port.metrics.windows_scored == ref.metrics.windows_scored
    assert port.metrics.products == ref.metrics.products > 0
    assert got == want
    assert os.path.isdir(tmp_path / "torch" / "hmmer")


def test_scan_cuda_without_gpu_raises():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tp.Scanner([frame_profile_from_arrays(**vars(sample_profile(1, 9)))],
                   tp.ScanConfig())


def test_scan_rejects_untaken_tiers():
    from deciphon_tpu.ops.costs import build_costs
    from deciphon_tpu_torch.scan.scheduler import BucketedPairScorer

    def costs(seed, K):
        return costs_from_arrays(**vars(build_costs(sample_profile(seed, K))))

    # Kp beyond the plain tiers takes the large-K tier (B4), up to the
    # reference's K = 16384
    big = BucketedPairScorer([costs(1, 5200)], "cpu")
    assert [(s.hbm_table, s.Kp) for s in big.scorers] == [(True, 5248)]
    with pytest.raises(NotImplementedError, match="16384"):
        BucketedPairScorer([costs(1, 16385)], "cpu")
    # tables beyond the device budget stream per wave, as the reference's
    # capacity ledger plans them
    over = BucketedPairScorer([costs(2, 9)], "cpu", hbm_budget=1000)
    assert [s.stream_tables for s in over.scorers] == [True]
    assert over.ledger.streamed_bytes == over.scorers[0].table_bytes()
    # the same for a packed class, whose inner scorer streams with it
    packed = BucketedPairScorer([costs(2, 9), costs(3, 12)], "cpu",
                                hbm_budget=1000)
    assert [(type(s).__name__, s.stream_tables, s.inner.stream_tables)
            for s in packed.scorers] == [("PackedPairScorer", True, True)]


def test_lrt_and_segment_hits_match_reference():
    assert tp.lrt(12.5, 3.25) == ref_pipeline.lrt(12.5, 3.25) == 18.5
    from deciphon_tpu_torch import states as st

    S, B, E, T, N, C = (st.STATE_S, st.STATE_B, st.STATE_E, st.STATE_T,
                        st.STATE_N, st.STATE_C)
    M1, M2 = st.make_match_id(0), st.make_match_id(1)
    for sids, sizes in [([S, N, B, M1, M2, E, C, T], [0, 3, 0, 3, 2, 0, 4, 0]),
                        ([S, N, C, T], [0, 2, 1, 0]),
                        ([S, B, M1, T], [0, 0, 3, 0])]:
        a = np.asarray(sids, np.int64), np.asarray(sizes, np.int64)
        assert tp.segment_hits(*a) == ref_pipeline.segment_hits(*a)


def test_pfam_ks_rule():
    ks = pfam_ks(200)
    assert len(ks) == 200 and ks[0] == 50 and ks[-1] == 2000
    assert ks == sorted(ks)
    assert pfam_ks(1) == [400] and pfam_ks(0) == []
