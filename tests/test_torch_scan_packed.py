"""The packed tiers as the default Scanner runs them, on the CPU.

A 10-profile database forms two packed classes (seg 64 and seg 256), one
singleton class (K = 600, back in a plain bucket) and one profile past
PACK_MAX_SEG (K = 1030, a plain bucket); reads are short enough to be
whole-read windows for most profiles and multi-window for K = 9.  The
port's products.tsv must be byte-identical to the reference's lax.scan
engine (engine="jax") on the default route (B7), under DECIPHON_NO_CHAIN=1
(B6) and with the unpacked scorer.  Class formation is held against the
reference's BucketedPairScorer on K lists.  Inputs are numpy-seeded and
cross into the port as arrays (deciphon_tpu_torch.convert).
"""

import numpy as np
import pytest
import torch

from deciphon_tpu.ops.costs import build_costs
from deciphon_tpu.profile import sample_profile
from deciphon_tpu.scan import pipeline as ref_pipeline
from deciphon_tpu.scan import scheduler as ref_sched
from deciphon_tpu.scan.sequence import Sequence
from deciphon_tpu_torch.convert import (costs_from_arrays,
                                        frame_profile_from_arrays,
                                        sequence_from_arrays)
from deciphon_tpu_torch.ops import viterbi as vk
from deciphon_tpu_torch.ops.tables import common_kp
from deciphon_tpu_torch.scan import pipeline as tp
from deciphon_tpu_torch.scan import scheduler as ts
from deciphon_tpu_torch.scan.window import Window
from deciphon_tpu_torch.workload import planted_read, random_bases

# One torch thread: the plain versions run thousands of small ops, and
# several test workers with a thread pool each starve one another.
torch.set_num_threads(1)

KS = [9, 20, 40, 55, 100, 120, 200, 230, 600, 1030]
PACKED = ("scores_pairs_packed", "scores_pairs_packed_chained")


@pytest.fixture(scope="module")
def db():
    ref_profiles = [sample_profile(300 + i, k) for i, k in enumerate(KS)]
    profiles = [frame_profile_from_arrays(**vars(p)) for p in ref_profiles]
    rng = np.random.default_rng(11)
    reads = [planted_read(rng, profiles[2], 300),
             planted_read(rng, profiles[5], 480, noise=0.01),
             planted_read(rng, profiles[0], 700),
             random_bases(rng, 250)]
    ref_seqs = [Sequence.make(i, f"r{i}", r) for i, r in enumerate(reads)]
    seqs = [sequence_from_arrays(**vars(s)) for s in ref_seqs]
    return (ref_profiles, ref_seqs), (profiles, seqs)


@pytest.fixture(scope="module")
def jax_products(db, tmp_path_factory):
    profiles, seqs = db[0]
    ref = ref_pipeline.Scanner(profiles,
                               ref_pipeline.ScanConfig(engine="jax"))
    out = ref.run(seqs, str(tmp_path_factory.mktemp("jax")))
    assert ref.metrics.products > 0
    with open(out, "rb") as fp:
        return fp.read()


@pytest.fixture
def counted(monkeypatch):
    """Calls per phase-1 wrapper, through the scheduler's module alias."""
    calls = {}
    for name in ("scores_pairs", "scores_pairs_chained",
                 "scores_pairs_mixed", "scores_pairs_chained_carry",
                 *PACKED):
        fn = getattr(vk, name)

        def wrapped(*a, _fn=fn, _name=name, **k):
            calls[_name] = calls.get(_name, 0) + 1
            return _fn(*a, **k)

        monkeypatch.setattr(vk, name, wrapped)
    return calls


def unpacked_scorer(costs):
    """The reference's custom-factory form: plain buckets only."""
    return ts.BucketedPairScorer(
        costs, "cpu", scorer_factory=lambda c: ts.PairScorer(
            c, "cpu", w=ts.BucketedPairScorer.plain_w(common_kp(c))))


@pytest.mark.parametrize("route", ["default", "no_chain", "unpacked"])
def test_packed_scan_products_byte_identical_to_jax(db, jax_products,
                                                    tmp_path, monkeypatch,
                                                    counted, route):
    profiles, seqs = db[1]
    if route == "no_chain":
        monkeypatch.setenv("DECIPHON_NO_CHAIN", "1")
    sc = tp.Scanner(profiles, tp.ScanConfig(device="cpu"),
                    scorer=unpacked_scorer if route == "unpacked" else None)
    kinds = [type(s).__name__ for s in sc.scorer.scorers]
    if route == "unpacked":
        assert kinds == ["PairScorer"] * 4  # buckets 128 256 1024 2048
    else:
        assert kinds == ["PackedPairScorer"] * 2 + ["PairScorer"] * 2
        assert [(s.seg, s.nseg, s.Kp) for s in sc.scorer.scorers[:2]] == [
            (256, 4, 1024), (64, 4, 256)]
        assert [s.Kp for s in sc.scorer.scorers[2:]] == [640, 1152]
    with open(sc.run(seqs, str(tmp_path / route)), "rb") as fp:
        got = fp.read()
    assert sc.metrics.survivors > 0
    assert got == jax_products
    used = set(counted)
    want = {"default": {"scores_pairs_packed_chained",
                        "scores_pairs_chained"},
            "no_chain": {"scores_pairs_packed", "scores_pairs"},
            "unpacked": {"scores_pairs_chained"}}[route]
    assert used == want


def formation(scorer):
    """[(kind, seg, nseg, Kp, member profile indices)] per sub-scorer."""
    members: dict[int, list[int]] = {}
    for gi, (si, local) in scorer._map.items():
        members.setdefault(si, []).append((local, gi))
    out = []
    for si, s in enumerate(scorer.scorers):
        idx = [gi for _, gi in sorted(members[si])]
        kp = s.Kp if hasattr(s, "Kp") else s._tables_host.shape[2]
        out.append((type(s).__name__, getattr(s, "seg", None),
                    getattr(s, "nseg", None), kp, idx))
    return out


@pytest.mark.parametrize("ks", [
    [30, 50, 60, 100, 120, 300, 5000],
    [150, 170, 188, 20, 25, 700, 701, 702, 703, 704],  # seg 192 and 704
    [62, 63, 126, 127, 254, 255, 510, 511, 1022, 1023, 1024],
    "seeded",
])
def test_class_formation_matches_reference(ks):
    if ks == "seeded":
        ks = np.random.default_rng(3).integers(5, 600, size=24).tolist()
    ref_costs = [build_costs(sample_profile(40 + i, k))
                 for i, k in enumerate(ks)]
    costs = [costs_from_arrays(**vars(c)) for c in ref_costs]
    want = formation(ref_sched.BucketedPairScorer(ref_costs, interpret=True))
    got = formation(ts.BucketedPairScorer(costs, "cpu"))
    assert got == want
    assert any(kind == "PackedPairScorer" for kind, *_ in got)
    for s in ts.BucketedPairScorer(costs, "cpu").scorers:
        if isinstance(s, ts.PackedPairScorer):
            assert (s.seg * s.nseg) % 128 == 0 and s.seg % 64 == 0
    # a custom factory keeps every profile in the plain buckets
    plain = unpacked_scorer(costs)
    assert all(isinstance(s, ts.PairScorer) for s in plain.scorers)
    ref_plain = ref_sched.BucketedPairScorer(
        ref_costs, interpret=True,
        scorer_factory=lambda c: ref_sched.PairScorer(c, interpret=True))
    assert [f[3:] for f in formation(plain)] == [
        f[3:] for f in formation(ref_plain) if f[3] <= 5120]


def packed_items(n_reads=5):
    """A 2-profile pack (K 9 and 20) and whole-read items of short reads."""
    costs = [costs_from_arrays(**vars(build_costs(sample_profile(s, k))))
             for s, k in [(1, 9), (2, 20)]]
    rng = np.random.default_rng(4)
    seqs = [sequence_from_arrays(
        **vars(Sequence.make(i, f"s{i}", random_bases(rng, 60 + 41 * i))))
        for i in range(n_reads)]
    codes = ts.DeviceSeqCodes(seqs, "cpu")
    items = [ts.PairItem(p_idx=p, s_idx=i, win=Window(0, 0, s.size),
                         multi_hits=True, hmmer3_compat=False, seq=s,
                         gstart=codes.gstart(i, 0))
             for p in range(2) for i, s in enumerate(seqs)]
    return costs, codes, items


def test_packed_leftover_chunk_at_narrow_width_launches_once(monkeypatch):
    """With w_c == 8 the narrow width w_n is also 8; every packed chain
    chunk is launched once (the reference loops over (w_c, w_n) and
    launches each twice)."""
    costs, codes, items = packed_items()
    scorer = ts.PackedPairScorer(costs, 2, "cpu")
    assert (scorer.seg, scorer.Kp) == (64, 128)
    scorer.set_device_codes(codes)
    launched = []
    real = scorer._invoke_scores_packed_chained

    def spy(pidx, sblk, wlen, *rest):
        launched.append(int((wlen > 0).sum()))
        return real(pidx, sblk, wlen, *rest)

    monkeypatch.setattr(scorer, "_invoke_scores_packed_chained", spy)
    inflight = scorer.dispatch(items)
    assert scorer._chain_pin[2] == 8  # w_c == w_n == 8
    assert sum(launched) == len(items) // 2  # one row per read
    got = scorer.collect(inflight)
    assert set(got) == {id(it) for it in items}
    # the packed chain tier, the packed rung tier and the inner scorer
    # agree bit for bit
    scorer.set_device_codes(codes)
    monkeypatch.setenv("DECIPHON_NO_CHAIN", "1")
    assert scorer.score(items) == got
    plain = ts.PairScorer(costs, "cpu")
    plain.set_device_codes(codes)
    assert plain.score(items) == got


def test_packed_dispatch_takes_items_without_a_read():
    """PairItem(seq=None) cannot be known to span its read: it rides the
    inner scorer (the reference reads it.seq.size and crashes)."""
    costs, codes, items = packed_items(n_reads=2)
    scorer = ts.PackedPairScorer(costs, 2, "cpu")
    scorer.set_device_codes(codes)
    want = scorer.score(items)
    bare = [ts.PairItem(p_idx=it.p_idx, s_idx=it.s_idx, win=it.win,
                        multi_hits=True, hmmer3_compat=False, seq=None,
                        gstart=it.gstart) for it in items]
    scorer.set_device_codes(codes)
    inflight = scorer.dispatch(bare)
    assert all(isinstance(e[0], (ts._Bucket, ts._ChainChunk))
               for e in inflight)
    got = scorer.collect(inflight)
    assert [got[id(b)] for b in bare] == [want[id(it)] for it in items]
    # streamed tables (the capacity ledger's mode): the next dispatch
    # places them again and gives the same scores; release drops both the
    # packed tables and the inner scorer's
    scorer.set_streaming(True)
    assert scorer.stream_tables and scorer.inner.stream_tables
    scorer.set_device_codes(codes)
    assert scorer.score(items) == want
    scorer.release_tables()
    assert scorer._tables_cache is None
    assert scorer.inner._tables_cache is None
