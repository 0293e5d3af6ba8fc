"""The streamed-table tier (a database over the device budget) and phase
2's bound on trellis bytes in flight, on the CPU.

The port's capacity ledger must flag the reference's scorers for a mixed
database (packed classes, plain buckets, a large-K bucket) under every
budget; no scorer places its tables before its first dispatch, and after
a wave's dispatch a streamed scorer holds none while a resident one keeps
them.  Scans with `hbm_budget=1` (everything streams, the reference's own
test budget, tests/test_ledger.py) write the reference's streamed scan's
products.tsv (Pallas interpret mode) and the port's resident scan's, byte
for byte, at the reference's caps and with the chain caps shrunk to 4
blocks, where the streamed gang runs `scores_pairs_mixed_large` (B4m).
With the phase-2 bound at one window's bytes, launches are collected
early and the products stay the same.  Inputs are numpy-seeded and cross
into the port as arrays (deciphon_tpu_torch.convert).
"""

import numpy as np
import pytest
import torch

from deciphon_tpu.ops import viterbi_pallas as vp
from deciphon_tpu.ops.costs import build_costs
from deciphon_tpu.profile import sample_profile
from deciphon_tpu.scan import pipeline as ref_pipeline
from deciphon_tpu.scan import scheduler as ref_sched
from deciphon_tpu.scan.sequence import Sequence
from deciphon_tpu_torch.convert import (costs_from_arrays,
                                        frame_profile_from_arrays,
                                        sequence_from_arrays)
from deciphon_tpu_torch.ops import viterbi as vk
from deciphon_tpu_torch.scan import pipeline as tp
from deciphon_tpu_torch.scan import scheduler as ts
from deciphon_tpu_torch.scan.window import Window
from deciphon_tpu_torch.workload import mixed_case, planted_read, random_bases

# One torch thread: the plain versions run thousands of small ops, and
# several test workers with a thread pool each starve one another.
torch.set_num_threads(1)

# two packed classes (seg 64: K 9, 20, 40; seg 256: K 150, 200), plain
# buckets (K 600 alone in its class, K 1500 past PACK_MAX_SEG) and a
# large-K bucket (K 5200)
MIXED_KS = [9, 20, 40, 150, 200, 600, 1500, 5200]


def mixed_scorers():
    ref_costs = [build_costs(sample_profile(20 + i, k))
                 for i, k in enumerate(MIXED_KS)]
    return ref_costs, [costs_from_arrays(**vars(c)) for c in ref_costs]


def placed(scorer) -> bool:
    """Whether a scorer (or a packed scorer's inner one) holds placed
    tables."""
    inner = getattr(scorer, "inner", None)
    return scorer._tables_cache is not None or (
        inner is not None and inner._tables_cache is not None)


def test_mixed_large_plain_bit_equal_to_pallas_hbm():
    """B4m's wrapper on CPU tensors runs B5's plain version (one plain
    version for one function) and launches nothing: bit-equal to the
    reference's `_gather_scores_pairs_hbm_mixed_jit` in interpret mode on
    real slots, +inf on pads.  It takes lane planes past B5's MAX_KP."""
    args = mixed_case(256, seed=9, n_pairs=2, w=8, lo=20, hi=300)
    before = dict(vk.LAUNCHES)
    alt, nul = vk.scores_pairs_mixed_large(**args)
    assert vk.LAUNCHES == before
    lens = args["lengths"].numpy()
    ra, rn = vp._gather_scores_pairs_hbm_mixed_jit(
        *(np.asarray(args[k].numpy()) for k in
          ("pidx", "tables", "tvecs", "xts", "lengths", "starts",
           "codes_all")),
        kappa=vk.KAPPA, nlb=-(-int(lens.max()) // vk.KAPPA), interpret=True)
    real = lens[..., 0] > 0
    assert np.array_equal(alt.numpy()[real], np.asarray(ra)[real])
    assert np.array_equal(nul.numpy()[real], np.asarray(rn)[real])
    assert np.isinf(alt.numpy()[~real]).all()
    wide = mixed_case(5632, seed=10, n_pairs=1, w=8, lo=5, hi=20)
    with pytest.raises(NotImplementedError):
        vk.scores_pairs_mixed(**wide)
    got = vk.scores_pairs_mixed_large(**wide)
    want = vk.scores_pairs_mixed_plain(**wide)
    assert all(torch.equal(a, b) for a, b in zip(got, want))


def test_ledger_flags_match_reference():
    ref_costs, costs = mixed_scorers()
    port = ts.BucketedPairScorer(costs, "cpu", hbm_budget=1)
    sizes = [s.table_bytes() for s in port.scorers]
    kinds = {type(s).__name__ for s in port.scorers}
    assert kinds == {"PackedPairScorer", "PairScorer"}
    assert any(getattr(s, "hbm_table", False) for s in port.scorers)
    total = sum(sizes)
    for budget in (1, min(sizes), total // 3, total // 2,
                   total - min(sizes), total):
        ref = ref_sched.BucketedPairScorer(ref_costs, interpret=True,
                                           hbm_budget=budget)
        got = ts.BucketedPairScorer(costs, "cpu", hbm_budget=budget)
        assert [s.table_bytes() for s in got.scorers] == \
            [s.table_bytes() for s in ref.scorers]
        flags = [s.stream_tables for s in got.scorers]
        assert flags == [s.stream_tables for s in ref.scorers]
        assert got.ledger.streamed == ref.ledger.streamed
        assert got.ledger.resident == ref.ledger.resident
        for s in got.scorers:  # a packed class streams with its inner
            if isinstance(s, ts.PackedPairScorer):
                assert s.inner.stream_tables == s.stream_tables
        # nothing is placed before the first dispatch
        assert not any(placed(s) for s in got.scorers)
    assert not any(ts.BucketedPairScorer(costs, "cpu", hbm_budget=total)
                   .ledger.streamed)


def wave(costs, n_reads=3):
    """Whole-read items of short random reads against every profile."""
    rng = np.random.default_rng(5)
    seqs = [sequence_from_arrays(**vars(Sequence.make(
        i, f"s{i}", random_bases(rng, 90 + 37 * i)))) for i in range(n_reads)]
    codes = ts.DeviceSeqCodes(seqs, "cpu")
    items = [ts.PairItem(p_idx=p, s_idx=i, win=Window(0, 0, s.size),
                         multi_hits=True, hmmer3_compat=False, seq=s,
                         gstart=codes.gstart(i, 0))
             for p in range(len(costs)) for i, s in enumerate(seqs)]
    return codes, items


def test_streamed_scorers_drop_tables_after_dispatch():
    """A packed class and a plain bucket under a budget that holds only
    the smaller: the larger streams.  After a wave's dispatch only the
    resident scorer holds placed tables, and the scores equal the
    all-resident scorer's."""
    _, costs = mixed_scorers()
    costs = costs[:3] + costs[5:6]  # seg-64 class (K 9, 20, 40), K 600
    every = ts.BucketedPairScorer(costs, "cpu")
    sizes = [s.table_bytes() for s in every.scorers]
    assert len(sizes) == 2 and sizes[0] != sizes[1]
    small = sizes.index(min(sizes))
    mixed = ts.BucketedPairScorer(costs, "cpu", hbm_budget=min(sizes))
    assert [s.stream_tables for s in mixed.scorers] == [i != small
                                                        for i in range(2)]
    codes, items = wave(costs)
    for b in (every, mixed):
        b.set_device_codes(codes)
        assert not any(placed(s) for s in b.scorers)
    want = every.collect_all(every.dispatch_all(items))
    ts.reset_uploads()
    pending = mixed.dispatch_all(items)
    assert [placed(s) for s in mixed.scorers] == [i == small
                                                  for i in range(2)]
    assert mixed.collect_all(pending) == want
    assert ts.UPLOADS["uploads"] > 0 and ts.UPLOADS["bytes"] > 0
    assert ts.UPLOADS["phase2"] == 0


def test_gang_bucket_walls_name_the_kernel(monkeypatch):
    """Under DECIPHON_SYNC_DEBUG=1 each gang launch is waited for and its
    wall and cells recorded under the reference's bucket name: bkt_gangv
    for the resident kernel (B5), bkt_gang for the streamed one (B4m)."""
    from deciphon_tpu_torch.logging import ScanMetrics

    monkeypatch.setenv("DECIPHON_SYNC_DEBUG", "1")
    _, costs = mixed_scorers()
    codes, items = wave(costs[:2])
    names = {}
    for stream in (False, True):
        scorer = ts.PairScorer(costs[:2], "cpu", w=8)
        scorer.set_streaming(stream)
        scorer.set_device_codes(codes)
        scorer.metrics = ScanMetrics()
        scorer._dispatch_gang(items)
        names[stream] = sorted(scorer.metrics.bucket_cells)
        true = sum(it.win.length * 5 * costs[it.p_idx].K for it in items)
        assert sum(t for t, _, _ in scorer.metrics.bucket_cells.values()) \
            == true
        assert set(names[stream]) <= set(scorer.metrics.walls)
    assert names[False] and all(n.startswith("bkt_gangv_kp128_")
                                for n in names[False])
    assert [n.replace("bkt_gangv_", "bkt_gang_") for n in names[False]] \
        == names[True]


@pytest.fixture(scope="module")
def planted():
    """tests/test_torch_scan_tiers.py's planted scan: three profiles (K 40
    and 9 pack side by side, K 150 has a plain bucket), five reads, two
    of them planted and one of 150 nt, whose 4-block windows pin a tiny
    chain cap when the caps are shrunk."""
    ref_profiles = [sample_profile(140, 40), sample_profile(250, 150),
                    sample_profile(109, 9)]
    profiles = [frame_profile_from_arrays(**vars(p)) for p in ref_profiles]
    rng = np.random.default_rng(7)
    reads = [planted_read(rng, profiles[0], 300),
             planted_read(rng, profiles[1], 500, noise=0.01),
             random_bases(rng, 250),
             planted_read(rng, profiles[2], 480),
             random_bases(rng, 150)]
    ref_seqs = [Sequence.make(i, f"r{i}", r) for i, r in enumerate(reads)]
    seqs = [sequence_from_arrays(**vars(s)) for s in ref_seqs]
    return (ref_profiles, ref_seqs), (profiles, seqs)


def port_scan(profiles, seqs, out, budget=None, scorer_hook=None):
    def make(costs):
        b = ts.BucketedPairScorer(costs, "cpu", hbm_budget=budget)
        if scorer_hook is not None:
            scorer_hook(b)
        return b

    sc = tp.Scanner(profiles, tp.ScanConfig(device="cpu"), scorer=make)
    with open(sc.run(seqs, str(out)), "rb") as fp:
        return fp.read(), sc


@pytest.fixture
def spied(monkeypatch):
    """Calls per gang wrapper, through the scheduler's module alias."""
    calls = {}
    for name in ("scores_pairs_mixed", "scores_pairs_mixed_large"):
        fn = getattr(vk, name)

        def wrapped(*a, _fn=fn, _name=name, **k):
            calls[_name] = calls.get(_name, 0) + 1
            return _fn(*a, **k)
        monkeypatch.setattr(vk, name, wrapped)
    return calls


@pytest.mark.parametrize("caps", ["reference", "shrunk"])
def test_streamed_scan_byte_identical(planted, tmp_path, monkeypatch,
                                      spied, caps):
    if caps == "shrunk":
        for cls in (ts.PairScorer, ref_sched.PairScorer):
            monkeypatch.setattr(cls, "CHAIN_MAX_BLK", 4)
            monkeypatch.setattr(cls, "NLB_FLOOR", 4)
    (ref_profiles, ref_seqs), (profiles, seqs) = planted
    ref = ref_pipeline.Scanner(
        ref_profiles, ref_pipeline.ScanConfig(engine="pallas-interpret"),
        scorer=lambda c: ref_sched.BucketedPairScorer(c, interpret=True,
                                                      hbm_budget=1))
    assert all(s.stream_tables for s in ref.scorer.scorers)
    with open(ref.run(ref_seqs, str(tmp_path / "ref")), "rb") as fp:
        want = fp.read()

    resident, _ = port_scan(profiles, seqs, tmp_path / "resident")
    assert not spied.get("scores_pairs_mixed_large")
    spied.clear()
    ts.reset_uploads()
    got, sc = port_scan(profiles, seqs, tmp_path / "streamed", budget=1)
    assert all(s.stream_tables for s in sc.scorer.scorers)
    assert sc.metrics.survivors > 0 and sc.metrics.products > 0
    assert got == want == resident
    # every wave places each streamed scorer's tables, and its survivors'
    # path launches place them once more; after the scan none is held
    assert ts.UPLOADS["uploads"] >= len(sc.scorer.scorers)
    assert ts.UPLOADS["phase2"] > 0
    assert not any(placed(s) for s in sc.scorer.scorers)
    if caps == "shrunk":  # the streamed gang: B4m, never B5
        assert spied.get("scores_pairs_mixed_large", 0) > 0
        assert not spied.get("scores_pairs_mixed")
    else:
        assert not spied


def test_phase2_bound_collects_early(planted, tmp_path):
    """A phase-2 bound of one window's trellis bytes collects every launch
    but the newest early; products stay byte for byte."""
    _, (profiles, seqs) = planted
    want, _ = port_scan(profiles, seqs, tmp_path / "unbounded")
    early = []

    def bound(b):
        b.path_inflight_bytes = vk.PATH_KAPPA * (128 + 1) * 4
        dispatch = b.paths_dispatch

        def spy(items):
            entries = dispatch(items)
            early.extend(len(e) for e in entries if isinstance(e, dict))
            return entries
        b.paths_dispatch = spy

    got, sc = port_scan(profiles, seqs, tmp_path / "bounded",
                        scorer_hook=bound)
    assert sc.metrics.survivors > 0
    assert got == want
    assert early and sum(early) > 0


def test_phase2_bound_derives_from_the_working_reserve():
    _, costs = mixed_scorers()
    b = ts.BucketedPairScorer(costs[:3], "cpu")
    assert b.path_inflight_bytes == int(
        ts.device_reserve("cpu") * ts.BucketedPairScorer.PATH_INFLIGHT_SHARE)
    assert ts.device_table_budget("cpu") + ts.device_reserve("cpu") == \
        16 << 30
