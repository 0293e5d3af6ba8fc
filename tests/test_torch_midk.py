"""The mid-K band (plain buckets 2560 to 5120, where B1, B3, B5 and B8 run
on thread-block clusters on the card) held on the CPU.

A scan with profiles in the 2560 and 5120 buckets (`pfam_midk`'s K 2100
and 4608, at lane widths 2176 and 4736) on reads of a few hundred nt, the
chain caps shrunk as tests/test_torch_scan_tiers.py shrinks them, so that
the planted reads' windows ride the gang (default), carry segments
(DECIPHON_CHAIN_SEG=1) or the classic buckets (DECIPHON_NO_CHAIN=1): its
products.tsv must be byte-identical to the reference's lax.scan engine
(engine="jax").  Then the mid-K cell itself (`workload.pfam_midk`) and the
launch shapes the four wrappers give the card at every lane width of the
band.  Inputs are numpy-seeded; products compare byte for byte.
"""

import numpy as np
import pytest
import torch

from deciphon_tpu.profile import sample_profile
from deciphon_tpu.scan import pipeline as ref_pipeline
from deciphon_tpu.scan.sequence import Sequence
from deciphon_tpu_torch import workload as wl
from deciphon_tpu_torch.convert import (frame_profile_from_arrays,
                                        sequence_from_arrays)
from deciphon_tpu_torch.frame import TABLE_SIZE
from deciphon_tpu_torch.ops import viterbi as vk
from deciphon_tpu_torch.scan import pipeline as tp
from deciphon_tpu_torch.scan import scheduler as ts

# One torch thread: the plain versions run thousands of small ops, and
# several test workers with a thread pool each starve one another.
torch.set_num_threads(1)

MIDK_INDEX = (0, 10)  # pfam_midk's K 2100 (bucket 2560) and 4608 (5120)
WRAPPERS = ("scores_pairs", "scores_pairs_chained", "scores_pairs_mixed",
            "scores_pairs_chained_carry")


@pytest.fixture(scope="module")
def planted():
    """Two mid-K profiles, reads of 360 nt carrying 120 nodes of each (1%
    noise), a random read and a 150-nt read, whose 4-block windows pin a
    chain cap of 4 blocks once the caps are shrunk.  Returns the
    reference's objects and the port's, carried across as arrays."""
    ref_profiles = [sample_profile(wl.MIDK_SEEDS[i], wl.MIDK_KS[i])
                    for i in MIDK_INDEX]
    profiles = [frame_profile_from_arrays(**vars(p)) for p in ref_profiles]
    rng = np.random.default_rng(17)
    reads = [wl.planted_read(rng, profiles[0], 360, noise=0.01,
                             nodes=(800, 920)),
             wl.planted_read(rng, profiles[1], 360, noise=0.01,
                             nodes=(2000, 2120)),
             wl.random_bases(rng, 250),
             wl.random_bases(rng, 150)]
    ref_seqs = [Sequence.make(i, f"m{i}", r) for i, r in enumerate(reads)]
    seqs = [sequence_from_arrays(**vars(s)) for s in ref_seqs]
    return (ref_profiles, ref_seqs), (profiles, seqs)


@pytest.fixture(scope="module")
def jax_products(planted, tmp_path_factory):
    profiles, seqs = planted[0]
    ref = ref_pipeline.Scanner(profiles,
                               ref_pipeline.ScanConfig(engine="jax"))
    with open(ref.run(seqs, str(tmp_path_factory.mktemp("jax"))), "rb") as fp:
        return fp.read()


@pytest.fixture
def calls(monkeypatch):
    """The lane widths of each phase-1 wrapper's calls."""
    seen: dict = {}
    for name in WRAPPERS:
        fn = getattr(vk, name)

        def wrapped(*a, _fn=fn, _name=name, **k):
            seen.setdefault(_name, []).append(
                (k["tables"] if "tables" in k else a[1]).shape[2])
            return _fn(*a, **k)

        monkeypatch.setattr(vk, name, wrapped)
    return seen


@pytest.mark.parametrize("route", ["gang", "seg", "classic"])
def test_midk_scan_byte_identical_to_jax(planted, jax_products, tmp_path,
                                         monkeypatch, calls, route):
    profiles, seqs = planted[1]
    monkeypatch.setattr(ts.PairScorer, "CHAIN_MAX_BLK", 4)
    monkeypatch.setattr(ts.PairScorer, "NLB_FLOOR", 4)
    if route == "seg":
        monkeypatch.setenv("DECIPHON_CHAIN_SEG", "1")
    if route == "classic":
        monkeypatch.setenv("DECIPHON_NO_CHAIN", "1")
    sc = tp.Scanner(profiles, tp.ScanConfig(device="cpu"))
    assert sorted(s.Kp for s in sc.scorer.scorers) == [2176, 4736]
    assert not any(s.hbm_table for s in sc.scorer.scorers)
    with open(sc.run(seqs, str(tmp_path / "torch")), "rb") as fp:
        got = fp.read()
    assert sc.metrics.survivors > 0 and sc.metrics.products > 0
    assert got == jax_products
    want = {"gang": {"scores_pairs_chained", "scores_pairs_mixed"},
            # the chainable windows ride the segment chunks' spare slots
            "seg": {"scores_pairs_chained_carry"},
            "classic": {"scores_pairs"}}[route]
    assert set(calls) == want
    # both buckets' lane widths, each past one CTA's 2048 lanes
    assert {Kp for kps in calls.values() for Kp in kps} == {2176, 4736}


def bucket(K: int) -> int:
    """The scheduler's plain bucket of a profile of K nodes."""
    kp = ts.round_up(max(K + 2, 128), 128)
    b = ts.next_pow2(kp)
    return ts.round_up(kp, 512) if b > 2048 else b


def test_pfam_midk_is_deterministic_two_profiles_a_bucket():
    profiles, seqs = wl.pfam_midk()
    again, seqs2 = wl.pfam_midk()
    assert [s.data for s in seqs] == [s.data for s in seqs2]
    for a, b in zip(profiles, again):
        assert np.array_equal(a.match_emission, b.match_emission)
        assert np.array_equal(a.trans, b.trans)
    ks = [p.core_size for p in profiles]
    assert ks == list(wl.MIDK_KS)
    buckets = [bucket(K) for K in ks]
    assert sorted(set(buckets)) == [2560, 3072, 3584, 4096, 4608, 5120]
    assert all(buckets.count(b) == 2 for b in set(buckets))
    assert max(buckets) == ts.BucketedPairScorer.MAX_KP == vk.MAX_KP
    assert [s.size for s in seqs] == list(wl.MIDK_READS)
    assert sorted(set(wl.MIDK_READS)) == [10_000, 24_000]
    # the planted reads carry their profiles' argmax-codon stretches
    for r, (p, (a, b)) in enumerate(wl.MIDK_PLANTED):
        assert 3 * (b - a) <= seqs[r].size
    sub, sub_seqs = wl.midk_subset(profiles)
    assert [p.core_size for p in sub] == [2100, 4608]
    assert [bucket(p.core_size) for p in sub] == [2560, 5120]
    assert all(1200 <= s.size <= 1260 for s in sub_seqs)  # 1% indels


def shape_args(key: str, Kp: int, N=1, W=2, C=2, T=4):
    """A wrapper's inputs at lane width Kp; the tables are left unfilled
    (only the launch is looked at)."""
    i32 = dict(dtype=torch.int32)
    base = dict(tables=torch.empty((1, TABLE_SIZE, Kp)),
                tvecs=torch.empty((1, 8, Kp)),
                codes_all=torch.zeros((T, 5), **i32))
    if key in ("score", "gang"):
        return dict(base, pidx=torch.zeros((N, W) if key == "gang" else (N,),
                                           **i32),
                    xts=torch.zeros((N, W, 16)),
                    lengths=torch.ones((N, W, 1), **i32),
                    starts=torch.zeros((N, W), **i32))
    chain = dict(base, pidx=torch.zeros((N,), **i32),
                 win_sblk=torch.zeros((N, W, C), **i32),
                 win_len=torch.ones((N, W, C), **i32),
                 win_gstart=torch.zeros((N, W, C), **i32),
                 win_xti=torch.zeros((N, W, C), **i32),
                 xt_lut=torch.zeros((1, 16)))
    if key == "carry":
        chain.update(conts=torch.zeros((N, W), **i32),
                     cbig_in=torch.empty((N, 13, vk.CW, Kp)),
                     csml_in=torch.empty((N, 32, vk.CW, 1)))
    return chain


KEYS = {"score": "scores_pairs", "gang": "scores_pairs_mixed",
        "chain": "scores_pairs_chained", "carry": "scores_pairs_chained_carry"}


@pytest.mark.parametrize("key", list(KEYS))
def test_midk_launch_shape_is_a_cluster(monkeypatch, key):
    """Every lane width of the band, 2176 to 5120 in steps of 128: each of
    B1, B5, B3 and B8 launches the score body's cluster shape under its
    own LAUNCHES key, c > 1 CTAs within one CTA's shared bytes and 352
    threads."""
    launched = []
    monkeypatch.setattr(vk, "on_cuda", lambda *tensors: True)
    monkeypatch.setattr(vk, "_launch_shaped",
                        lambda fn, k, Kp, shape, *args:
                        launched.append((k, Kp, shape)))
    kps = list(range(2176, vk.MAX_KP + 1, 128))
    for Kp in kps:
        getattr(vk, KEYS[key])(**shape_args(key, Kp))
    assert [Kp for _, Kp, _ in launched] == kps
    for k, Kp, s in launched:
        assert k == key and s == vk.cluster_shape(Kp, "score"), (Kp, s)
        assert 1 < s.c <= vk.MAX_CLUSTER and s.lpt == 4, (Kp, s)
        assert s.threads <= 352 and s.threads * s.lpt == s.w, (Kp, s)
        assert s.smem == vk.SCORE_PLANES * s.w * 4 <= vk.SMEM_BYTES, (Kp, s)
        assert (s.c - 1) * s.w < Kp <= s.c * s.w, (Kp, s)
    # at the widest plain bucket: 10 CTAs of 512 lanes, 128 threads each
    assert launched[-1][2] == vk.ClusterShape(10, 512, 4, 128, 47104)


def test_score_source_has_no_lane_loop():
    """One DP body: the first port's lane loop and its planes are gone,
    and every score-family entry point takes the launch shape."""
    from deciphon_tpu_torch import _build

    src = (_build.CSRC / "viterbi_score.cu").read_text()
    assert "score_window(" not in src and "kStatePlanes" not in src
    assert "fast_lpt" not in src
    for fn in ("dtt_score_pairs", "dtt_score_mixed", "dtt_score_chained",
               "dtt_score_chained_carry", "dtt_score_grid"):
        sig = _build.SIGNATURES[fn]
        assert sig[-7:] == [_build._I] * 5 + [_build._IP, _build._P], fn
