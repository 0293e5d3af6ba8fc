"""Port parity of the large-K tier: B4 (`scores_pairs_large`) and the
large-K routing of the scheduler, B2 past 5120 lanes, against the
reference.

B4's plain version (B1's) is held bit for bit against the Pallas HBM-table
kernel in interpret mode and, at a real large-K width, against the lax.scan
engine within the reference's cross-engine tolerance
(tests/test_pallas.py); B2's plain version at that width walks the same
steps as `viterbi_path_batch` + `_unzip_batch_jit`; the scheduler builds
the reference's large-K buckets; and scans whose profiles ride B4 + B2
write `engine="jax"`'s products byte for byte.  Inputs are numpy-seeded.
"""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from deciphon_tpu.ops import viterbi_pallas as vp
from deciphon_tpu.ops.costs import build_costs
from deciphon_tpu.ops.engine import scan_scores_jit
from deciphon_tpu.ops.traceback import _unzip_batch_jit
from deciphon_tpu.ops.viterbi_jax import viterbi_path_batch
from deciphon_tpu.profile import sample_profile
from deciphon_tpu.scan import pipeline as ref_pipeline
from deciphon_tpu.scan import scheduler as ref_sched
from deciphon_tpu.scan.sequence import Sequence, frag_codes_ending
from deciphon_tpu_torch.convert import (costs_from_arrays,
                                        frame_profile_from_arrays,
                                        sequence_from_arrays)
from deciphon_tpu_torch.ops import traceback as tb
from deciphon_tpu_torch.ops import viterbi as vk
from deciphon_tpu_torch.ops.tables import stack_tables
from deciphon_tpu_torch.scan import pipeline as tp
from deciphon_tpu_torch.scan import scheduler as ts
from deciphon_tpu_torch.workload import planted_read, random_bases, window_batch

# One torch thread: the plain versions run thousands of small ops, and
# several test workers with a thread pool each starve one another.
torch.set_num_threads(1)


def make_inputs(Ks, lens, seed, mh=True, h3c=False):
    """Reference costs and the B4 wrapper's CPU arguments: pair n scores
    against profile n % len(Ks), slots of length 0 are pads."""
    costs = [build_costs(sample_profile(seed + i, k), mh, h3c)
             for i, k in enumerate(Ks)]
    tables, tvecs = stack_tables([costs_from_arrays(**vars(c))
                                  for c in costs])
    lens = np.asarray(lens, np.int32)
    pidx = torch.tensor([i % len(Ks) for i in range(lens.shape[0])],
                        dtype=torch.int32)
    batch = window_batch(np.random.default_rng(seed), lens, "cpu", mh, h3c)
    return costs, dict(pidx=pidx, tables=tables, tvecs=tvecs, **batch)


def window_codes(inp, n, slots, lens):
    """END-indexed codes (B, Lmax, 5) of pair n's slots, as the lax.scan
    engines take them."""
    codes_all = inp["codes_all"].numpy()
    codes = np.zeros((len(slots), int(lens.max()), 5), np.int32)
    for b, w in enumerate(slots):
        L, s = int(lens[n, w]), int(inp["starts"][n, w])
        codes[b, :L] = frag_codes_ending(codes_all[s:s + L, 0])
    return codes


def test_large_plain_bit_equal_to_pallas_hbm():
    lens = np.array([[120, 1, 0, 41, 80, 0, 7, 96],
                     [33, 0, 0, 118, 40, 1, 0, 0]], np.int32)
    _, inp = make_inputs([150, 60], lens, seed=21)
    assert inp["tables"].shape[2] == 256
    alt, nul = vk.scores_pairs_large(**inp)  # CPU tensors: plain
    assert alt.dtype == torch.float32 and tuple(alt.shape) == lens.shape
    assert vk.LAUNCHES["large"] == 0
    args = [jnp.asarray(inp[k].numpy()) for k in
            ("pidx", "tables", "tvecs", "xts", "lengths", "starts",
             "codes_all")]
    ra, rn = vp._gather_scores_pairs_hbm_jit(
        *args, kappa=vp.KAPPA_PENDING, nlb=-(-int(lens.max()) // vk.KAPPA),
        interpret=True)
    real = lens > 0
    assert np.array_equal(alt.numpy()[real], np.asarray(ra)[real])
    assert np.array_equal(nul.numpy()[real], np.asarray(rn)[real])
    assert np.isinf(alt.numpy()[~real]).all()
    assert np.isfinite(alt.numpy()[real]).all()


def test_large_plain_matches_jax_engine_at_large_k():
    lens = np.array([[80, 1, 0, 37, 64, 0, 0, 12]], np.int32)
    costs, inp = make_inputs([5200], lens, seed=5)
    assert inp["tables"].shape[2] == 5248 > vk.MAX_KP
    alt, nul = vk.scores_pairs_large(**inp)
    slots = [w for w in range(lens.shape[1]) if lens[0, w] > 0]
    c = costs[0]
    nu, al = scan_scores_jit(
        jnp.asarray(c.core)[None], jnp.asarray(c.match)[None],
        jnp.asarray(c.null)[None], jnp.asarray(c.background)[None],
        jnp.asarray(inp["xts"][0, slots, :13].numpy()),
        jnp.asarray(window_codes(inp, 0, slots, lens)),
        jnp.asarray(lens[0, slots]))
    np.testing.assert_allclose(alt.numpy()[0, slots], np.asarray(al)[0],
                               rtol=2e-6, atol=2e-5)
    np.testing.assert_allclose(nul.numpy()[0, slots], np.asarray(nu)[0],
                               rtol=2e-6, atol=2e-5)
    with pytest.raises(NotImplementedError, match="16384"):
        wide = torch.zeros((1, 1364, vk.MAX_LARGE_KP + 128))
        vk.scores_pairs_large(**dict(inp, tables=wide, tvecs=torch.zeros(
            (1, 8, vk.MAX_LARGE_KP + 128))))


def test_path_plain_walks_like_viterbi_jax_at_large_k():
    lens = np.array([[70, 0, 1, 45]], np.int32)
    costs, inp = make_inputs([5200], lens, seed=9)
    nlb = -(-int(lens.max()) // vk.PATH_KAPPA)
    xn, nd = vk.paths_pairs(**inp, nlb=nlb)
    W, Lk, Kp = lens.shape[1], xn.shape[2], nd.shape[3]
    slots = [w for w in range(W) if lens[0, w] > 0]
    rows = torch.tensor(slots, dtype=torch.int32)
    lt = torch.tensor(lens[0, slots], dtype=torch.int32)
    max_steps = Lk + 4 * Kp + 64
    sts, szs, ns, oks = tb.walk(xn.reshape(W, Lk), nd.reshape(W, Lk, Kp),
                                rows, lt, max_steps)
    c = costs[0]
    _, rxn, rnd = viterbi_path_batch(
        jnp.asarray(c.core), jnp.asarray(c.match), jnp.asarray(c.null),
        jnp.asarray(c.background),
        jnp.asarray(inp["xts"][0, slots, :13].numpy()),
        jnp.asarray(window_codes(inp, 0, slots, lens)),
        jnp.asarray(lens[0, slots]))
    rs, rz, rn, rok = _unzip_batch_jit(rxn, rnd, jnp.asarray(lt.numpy()),
                                       max_steps=max_steps)
    assert oks.all() and np.asarray(rok).all()
    assert np.array_equal(ns.numpy(), np.asarray(rn))
    for b in range(len(slots)):
        n = int(ns[b])
        assert np.array_equal(sts[b, :n].numpy().view(np.uint16),
                              np.asarray(rs)[b, :n])
        assert np.array_equal(szs[b, :n].numpy(), np.asarray(rz)[b, :n])


def port_costs(seed, K):
    return costs_from_arrays(**vars(build_costs(sample_profile(seed, K))))


@pytest.mark.parametrize("Ks", [[5119], [5200, 6000], [5118, 5119, 2000]])
def test_large_k_buckets_match_reference(Ks):
    ref_costs = [build_costs(sample_profile(3 + i, k))
                 for i, k in enumerate(Ks)]
    ref = ref_sched.BucketedPairScorer(ref_costs, interpret=True)
    port = ts.BucketedPairScorer(
        [costs_from_arrays(**vars(c)) for c in ref_costs], "cpu")
    want = [(s.hbm_table, s.w, s._tables_host.shape[2])
            for s in ref.scorers]
    got = [(s.hbm_table, s.w, s.Kp) for s in port.scorers]
    assert got == want


def test_large_k_up_to_reference_limit():
    """K = 16384, the reference's largest profile, builds a large-K scorer
    (bucket 16896, tables at Kp 16512, w 16); K = 16385 raises."""
    port = ts.BucketedPairScorer([port_costs(2, 16384)], "cpu")
    assert [(s.hbm_table, s.w, s.Kp) for s in port.scorers] == \
        [(True, 16, 16512)]
    with pytest.raises(NotImplementedError, match="16384"):
        ts.BucketedPairScorer([port_costs(2, 16385)], "cpu")


@pytest.fixture
def spied(monkeypatch):
    """Calls per kernel wrapper, through the scheduler's module alias."""
    calls = {}
    for name in ("scores_pairs", "scores_pairs_chained",
                 "scores_pairs_mixed", "scores_pairs_chained_carry",
                 "scores_pairs_packed", "scores_pairs_packed_chained",
                 "scores_pairs_large", "paths_pairs"):
        fn = getattr(vk, name)

        def wrapped(*a, _fn=fn, _name=name, **k):
            calls[_name] = calls.get(_name, 0) + 1
            return _fn(*a, **k)
        monkeypatch.setattr(vk, name, wrapped)
    return calls


def scan_both(ref_profiles, reads, tmp_path, mh=True, h3c=False):
    """products.tsv of the reference's lax.scan engine and of the port on
    the CPU, and the port's Scanner."""
    ref_seqs = [Sequence.make(i, f"r{i}", r) for i, r in enumerate(reads)]
    ref = ref_pipeline.Scanner(ref_profiles, ref_pipeline.ScanConfig(
        engine="jax", multi_hits=mh, hmmer3_compat=h3c))
    with open(ref.run(ref_seqs, str(tmp_path / "jax")), "rb") as fp:
        want = fp.read()
    sc = tp.Scanner([frame_profile_from_arrays(**vars(p))
                     for p in ref_profiles],
                    tp.ScanConfig(device="cpu", multi_hits=mh,
                                  hmmer3_compat=h3c))
    seqs = [sequence_from_arrays(**vars(s)) for s in ref_seqs]
    with open(sc.run(seqs, str(tmp_path / "torch")), "rb") as fp:
        return want, fp.read(), sc


@pytest.mark.parametrize("mh,h3c", [(True, False), (False, True)])
def test_scan_on_large_tier_byte_identical_to_jax(tmp_path, monkeypatch,
                                                  spied, mh, h3c):
    """With MAX_KP lowered to 64 and packing off, every profile's bucket
    rides the large-K tier: phase 1 on B4 alone, phase 2 on B2."""
    monkeypatch.setattr(ts.BucketedPairScorer, "MAX_KP", 64)
    monkeypatch.setattr(ts.BucketedPairScorer, "PACK_MAX_SEG", 0)
    ref_profiles = [sample_profile(140, 40), sample_profile(250, 150),
                    sample_profile(109, 9)]
    profiles = [frame_profile_from_arrays(**vars(p)) for p in ref_profiles]
    rng = np.random.default_rng(7)
    reads = [planted_read(rng, profiles[0], 300),
             planted_read(rng, profiles[1], 500, noise=0.01),
             random_bases(rng, 250),
             planted_read(rng, profiles[2], 480)]
    want, got, sc = scan_both(ref_profiles, reads, tmp_path, mh, h3c)
    assert all(s.hbm_table for s in sc.scorer.scorers)
    assert sc.metrics.survivors > 0 and sc.metrics.products > 0
    assert got == want
    assert set(spied) == {"scores_pairs_large", "paths_pairs"}


def test_scan_real_large_k_byte_identical_to_jax(tmp_path, spied):
    """A K = 5200 profile (Kp 5248, bucket 5632) beside a small one, on two
    reads of at most 900 nt, one carrying a stretch of its domain."""
    ref_profiles = [sample_profile(600, 5200), sample_profile(140, 40)]
    big = frame_profile_from_arrays(**vars(ref_profiles[0]))
    rng = np.random.default_rng(11)
    reads = [planted_read(rng, big, 900, noise=0.01, nodes=(1000, 1250)),
             random_bases(rng, 700)]
    want, got, sc = scan_both(ref_profiles, reads, tmp_path)
    assert [(s.hbm_table, s.Kp) for s in sc.scorer.scorers] == \
        [(False, 128), (True, 5248)]
    assert b"SAMPLE600" in got  # the stretch survived on the large tier
    assert got == want
    assert {"scores_pairs_large", "paths_pairs"} <= set(spied)


def test_large_path_launches_within_byte_cap(monkeypatch):
    """Large-K survivors of one rung share a path launch, one window per
    pair whatever its profile, unpadded; PATH_BATCH_BYTES splits them,
    one window per launch at least, and the walked steps stay the same."""
    from deciphon_tpu_torch.scan.window import Window

    costs = [port_costs(1, 40), port_costs(2, 9)]
    scorer = ts.PairScorer(costs, "cpu", w=8, hbm_table=True)
    rng = np.random.default_rng(3)
    seqs = [sequence_from_arrays(**vars(Sequence.make(
        i, f"s{i}", random_bases(rng, 100)))) for i in range(3)]
    codes = ts.DeviceSeqCodes(seqs, "cpu")
    scorer.set_device_codes(codes)
    items = [ts.PairItem(p_idx=p, s_idx=i, win=Window(0, 0, s.size),
                         multi_hits=True, hmmer3_compat=False, seq=s,
                         gstart=codes.gstart(i, 0))
             for p in range(2) for i, s in enumerate(seqs)]
    buckets = scorer._path_buckets(items)
    assert [(len(b.groups), b.w) for b in buckets] == [(6, 1)]
    together = [launch() for _, launch in scorer.path_launches(items)]
    assert len(together) == 1 and together[0][5].shape[0] == 6  # no pads
    one = 4 * vk.PATH_KAPPA * buckets[0].nlb * (scorer.Kp + 1)
    monkeypatch.setattr(ts.PairScorer, "PATH_BATCH_BYTES", 2 * one + 1)
    assert [len(b.groups) for b in scorer._path_buckets(items)] == [2, 2, 2]
    monkeypatch.setattr(ts.PairScorer, "PATH_BATCH_BYTES", 1)
    alone = [launch() for _, launch in scorer.path_launches(items)]
    assert [len(e[0]) for e in alone] == [1] * 6
    steps = {id(e[0][0]): e[1:5] for e in alone}
    for r, it in enumerate(together[0][0]):
        for a, b in zip(steps[id(it)], together[0][1:5]):
            assert torch.equal(a[0], b[r])
