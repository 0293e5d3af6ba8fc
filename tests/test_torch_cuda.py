"""Card tests of the port: each CUDA kernel against its plain PyTorch
version on the same CUDA tensors, and the scan on the card against the
scan on the CPU.  They need an NVIDIA card with nvcc and skip elsewhere.

They import nothing but the port.  The card's machine has no jax, so run
them without the repo's conftest:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_cuda.py
"""

import dataclasses
import io

import numpy as np
import pytest
import torch

from deciphon_tpu_torch.hmmer import forward as hf
from deciphon_tpu_torch.ops import traceback as tb
from deciphon_tpu_torch.ops import viterbi as vk
from deciphon_tpu_torch.ops.costs import (CT_BM, CT_DD, CT_DDCUM,
                                         build_costs, dd_cum_row)
from deciphon_tpu_torch.ops.tables import stack_tables
from deciphon_tpu_torch.profile import sample_profile
from deciphon_tpu_torch.scan import pipeline as tp
from deciphon_tpu_torch.scan import scheduler as ts
from deciphon_tpu_torch.scan.sequence import Sequence
from deciphon_tpu_torch.workload import (amino_hits, assemble_walk_cases,
                                         carry_case,
                                         chain_case, mixed_case,
                                         packed_case, packed_chain_case,
                                         planted_read, random_bases,
                                         run_carry_calls, walk_cases,
                                         window_batch, window_scores)

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (kernels have no CPU mode)")
    return torch.device("cuda")


def tied(costs):
    """The same profile with every emission and transition cost equal:
    paths of one length tie, so the first-minimum order of the candidates
    decides nearly every trellis word."""
    core = costs.core.copy()
    core[:8] = np.where(np.isfinite(core[:8]), np.float32(0.5), core[:8])
    core[CT_DDCUM] = dd_cum_row(core[CT_DD])
    return dataclasses.replace(
        costs, core=core, match=np.full_like(costs.match, 2.0),
        null=np.full_like(costs.null, 1.5),
        background=np.full_like(costs.background, 1.5))


def inputs(dev, Ks, Kp, lens, seed, ties=False):
    costs = [build_costs(sample_profile(seed + i, k)) for i, k in
             enumerate(Ks)]
    if ties:
        costs = [tied(c) for c in costs]
    tables, tvecs = (t.to(dev) for t in stack_tables(costs, Kp))
    lens = np.asarray(lens, np.int32)
    pidx = torch.tensor([i % len(Ks) for i in range(lens.shape[0])],
                        dtype=torch.int32, device=dev)
    return dict(pidx=pidx, tables=tables, tvecs=tvecs,
                **window_batch(np.random.default_rng(seed), lens, dev))


@pytest.mark.parametrize("Kp", [128, 640, 5120])
def test_score_kernel_bit_equal_to_plain(cuda, Kp):
    lens = [[300, 1, 0, 45], [81, 0, 0, 0]]
    inp = inputs(cuda, [Kp - 2, 17], Kp, lens, seed=Kp)
    before = vk.LAUNCHES["score"]
    alt, nul = vk.scores_pairs(**inp)
    assert vk.LAUNCHES["score"] == before + 1
    pa, pn = vk.scores_pairs_plain(**inp)
    torch.cuda.synchronize()
    assert torch.equal(alt, pa) and torch.equal(nul, pn)
    assert torch.isinf(alt[0, 2]) and torch.isfinite(alt[0, 0])


@pytest.mark.parametrize("Kp", [5632, 16896])
def test_large_kernel_bit_equal_to_plain(cuda, Kp):
    lens = [[300, 1, 0, 45, 120, 7, 0, 200], [0, 81, 0, 0, 0, 0, 0, 0]]
    inp = inputs(cuda, [Kp - 2, 17], Kp, lens, seed=Kp)
    before = vk.LAUNCHES["large"]
    alt, nul = vk.scores_pairs_large(**inp)
    assert vk.LAUNCHES["large"] == before + 1
    pa, pn = vk.scores_pairs_plain(**inp)
    torch.cuda.synchronize()
    assert torch.equal(alt, pa) and torch.equal(nul, pn)
    assert torch.isinf(alt[0, 2]) and torch.isfinite(alt[0, 0])


@pytest.mark.parametrize("Kp", [1024, 2048, 5120])
def test_large_kernel_bit_equal_to_b1(cuda, Kp):
    """B4 against B1 on the same windows, and both against the plain
    version: one CTA a window up to Kp 2048, a cluster at 5120 (both
    wrappers on one launcher since the lane loop went)."""
    lens = [[300, 1, 0, 45], [81, 0, 200, 0]]
    inp = inputs(cuda, [Kp - 2, 17], Kp, lens, seed=Kp + 5)
    a1, n1 = vk.scores_pairs(**inp)
    a4, n4 = vk.scores_pairs_large(**inp)
    pa, pn = vk.scores_pairs_plain(**inp)
    torch.cuda.synchronize()
    assert torch.equal(a1, a4) and torch.equal(n1, n4)
    assert torch.equal(a4, pa) and torch.equal(n4, pn)
    assert (vk.SHAPES[("large", Kp)]["c"] > 1) == (Kp > 2048)


@pytest.mark.parametrize("Kp", [128, 640, 3072, 16896])
def test_path_kernel_and_walk_bit_equal_to_plain(cuda, Kp):
    lens = [[150, 1, 0, 77]]
    inp = inputs(cuda, [Kp - 2], Kp, lens, seed=Kp + 1)
    nlb = -(-150 // vk.PATH_KAPPA)
    xn, nd = vk.paths_pairs(**inp, nlb=nlb)
    px, pd = vk.paths_pairs_plain(**inp, nlb=nlb)
    torch.cuda.synchronize()
    for w, L in enumerate(lens[0]):
        assert torch.equal(xn[0, w, :L], px[0, w, :L])
        assert torch.equal(nd[0, w, :L], pd[0, w, :L])
    Lk = xn.shape[2]
    xnf, ndf = xn.reshape(4, Lk), nd.reshape(4, Lk, Kp)
    rows = torch.tensor([0, 3, 1], dtype=torch.int32, device=cuda)
    lt = torch.tensor([150, 77, 1], dtype=torch.int32, device=cuda)
    steps = Lk + 4 * Kp + 64
    got = tb.walk(xnf, ndf, rows, lt, steps)
    want = tb.walk_plain(xnf, ndf, rows, lt, steps)
    torch.cuda.synchronize()
    assert all(torch.equal(a, b) for a, b in zip(got, want))
    assert got[3].all()


@pytest.mark.parametrize("Kp", [128, 1024, 5120])
def test_chained_kernel_bit_equal_to_plain(cuda, Kp):
    inp = chain_case(Kp, seed=Kp, device=cuda, lo=40, hi=400)
    before = vk.LAUNCHES["chain"]
    alt, nul = vk.scores_pairs_chained(**inp)
    assert vk.LAUNCHES["chain"] == before + 1
    pa, pn = vk.scores_pairs_chained_plain(**inp)
    torch.cuda.synchronize()
    assert torch.equal(alt, pa) and torch.equal(nul, pn)  # pads +inf too
    real = inp["win_len"] > 0
    assert torch.isfinite(alt[real]).all() and torch.isinf(alt[-1]).all()


@pytest.mark.parametrize("Kp", [128, 1024, 5120])
def test_mixed_kernel_bit_equal_to_plain(cuda, Kp):
    inp = mixed_case(Kp, seed=Kp + 2, device=cuda, hi=600)
    before = vk.LAUNCHES["gang"]
    alt, nul = vk.scores_pairs_mixed(**inp)
    assert vk.LAUNCHES["gang"] == before + 1
    pa, pn = vk.scores_pairs_mixed_plain(**inp)
    torch.cuda.synchronize()
    assert torch.equal(alt, pa) and torch.equal(nul, pn)


@pytest.mark.parametrize("Kp", [128, 1024, 2048, 5120])
def test_mixed_large_kernel_bit_equal_to_plain_and_b5(cuda, Kp):
    """B4m (the streamed gang) computes B5's function: bit-equal to the
    one plain version and to B5 on the same arguments."""
    inp = mixed_case(Kp, seed=Kp + 7, device=cuda, hi=600)
    before = vk.LAUNCHES["gang_large"]
    alt, nul = vk.scores_pairs_mixed_large(**inp)
    assert vk.LAUNCHES["gang_large"] == before + 1
    pa, pn = vk.scores_pairs_mixed_plain(**inp)
    ba, bn = vk.scores_pairs_mixed(**inp)
    torch.cuda.synchronize()
    assert torch.equal(alt, pa) and torch.equal(nul, pn)
    assert torch.equal(alt, ba) and torch.equal(nul, bn)


@pytest.mark.parametrize("Kp", [128, 1024, 2176, 5120])
def test_carry_kernel_segments_equal_whole_window(cuda, Kp):
    case = carry_case(Kp, seed=Kp + 3, device=cuda)
    before = vk.LAUNCHES["carry"]
    got = run_carry_calls(vk.scores_pairs_chained_carry, case)
    assert vk.LAUNCHES["carry"] == before + len(case["calls"]) >= 3
    want = run_carry_calls(vk.scores_pairs_chained_carry_plain, case)
    wa, wn = window_scores(case["tables"], case["tvecs"], case["codes_all"],
                           0, [case["whole"]] + case["rides"])
    torch.cuda.synchronize()
    last = len(got) - 1
    for t, (g, w) in enumerate(zip(got, want)):
        for slot in ([0, 1] if t == last else [1]):
            assert torch.equal(g[0][0, slot, 0], w[0][0, slot, 0]), (t, slot)
            assert torch.equal(g[1][0, slot, 0], w[1][0, slot, 0]), (t, slot)
        if t < last:  # the continuing slot's exported planes
            assert torch.equal(g[2][:, :, 0], w[2][:, :, 0])
            assert torch.equal(g[3][:, :, 0], w[3][:, :, 0])
        assert g[0][0, 1, 0] == wa[1 + t] and g[1][0, 1, 0] == wn[1 + t]
    assert got[last][0][0, 0, 0] == wa[0] and got[last][1][0, 0, 0] == wn[0]


# planes (seg, nseg): 2 lanes a thread (Kp 128, 384) and 4 (the rest),
# segments of 16, 32, 48, 112 and 256 threads (16, 48 and 112 put a
# segment boundary inside a warp), Kp 384 (not a power of two), the Pfam
# scan's classes (64, 2), (448, 2), (192, 6) and (1024, 2), and the widest
# plane in 32 segments
PACKED_PLANES = [(64, 2), (192, 2), (128, 8), (192, 8), (64, 32), (1024, 2),
                 (448, 2), (192, 6)]


@pytest.mark.parametrize("seg,nseg", PACKED_PLANES)
def test_packed_kernel_bit_equal_to_plain(cuda, seg, nseg):
    inp = packed_case(seg, nseg, seed=seg + nseg, device=cuda, hi=600)
    before = vk.LAUNCHES["packed"]
    alt, nul = vk.scores_pairs_packed(**inp)
    assert vk.LAUNCHES["packed"] == before + 1
    pa, pn = vk.scores_pairs_packed_plain(**inp)
    torch.cuda.synchronize()
    assert torch.equal(alt, pa) and torch.equal(nul, pn)  # pads +inf too
    assert torch.isfinite(alt[0, 0]).all()  # a full pack
    assert torch.isinf(alt[1, :, -1]).all()  # the missing segment
    assert torch.isfinite(alt[1, 0, :-1]).all()


@pytest.mark.parametrize("per_segment", [False, True])
@pytest.mark.parametrize("seg,nseg", PACKED_PLANES)
def test_packed_chained_kernel_bit_equal_to_plain(cuda, seg, nseg,
                                                  per_segment):
    inp = packed_chain_case(seg, nseg, seed=seg + nseg + 1, device=cuda,
                            lo=40, hi=400, per_segment=per_segment)
    before = vk.LAUNCHES["pchain"]
    alt, nul = vk.scores_pairs_packed_chained(**inp)
    assert vk.LAUNCHES["pchain"] == before + 1
    pa, pn = vk.scores_pairs_packed_chained_plain(**inp)
    torch.cuda.synchronize()
    assert torch.equal(alt, pa) and torch.equal(nul, pn)
    real = inp["win_len"] > 0
    assert torch.isfinite(alt[0][real[0]]).all()  # pair 0: a full pack
    assert torch.isinf(alt[~real]).all() and torch.isinf(alt[-1]).all()


def grid_inputs(dev, Ks, Kp, lens, seed):
    """B9's inputs: P profiles against every window of `lens` (B,)."""
    inp = inputs(dev, Ks, Kp, [lens], seed)
    return dict(tables=inp["tables"], tvecs=inp["tvecs"],
                xts=inp["xts"][0].contiguous(),
                lengths=inp["lengths"][0, :, 0].contiguous(),
                starts=inp["starts"][0].contiguous(),
                codes_all=inp["codes_all"])


# B9 runs the score body in B4's launch shape: one CTA a window up to Kp
# 2048, a cluster from 2176
GRID_KPS = [128, 1024, 2048, 2176, 5632]


@pytest.mark.parametrize("Kp", GRID_KPS)
def test_grid_kernel_bit_equal_to_plain(cuda, Kp):
    inp = grid_inputs(cuda, [Kp - 2, 17], Kp, [300, 1, 0, 45, 97], Kp + 7)
    before = vk.LAUNCHES["grid"]
    alt, nul = vk.scores_grid(**inp)
    assert vk.LAUNCHES["grid"] == before + 1
    shape = vk.SHAPES[("grid", Kp)]
    assert shape["c"] == vk.cluster_shape(Kp).c and (shape["c"] > 1) == (
        Kp > 2048)
    pa, pn = vk.scores_grid_plain(**inp)
    torch.cuda.synchronize()
    assert alt.shape == (2, 5)
    assert torch.equal(alt, pa) and torch.equal(nul, pn)
    assert torch.isinf(alt[:, 2]).all() and torch.isfinite(alt[:, 1]).all()


@pytest.mark.parametrize("Kp", GRID_KPS)
def test_grid_kernel_bit_equal_to_b1(cuda, Kp):
    """B9 on every (profile, window) pair against the push form on the
    same pairs: B1, or B4 past its 5120 lanes."""
    lens = [300, 1, 0, 45, 97]
    inp = grid_inputs(cuda, [Kp - 2, 17], Kp, lens, Kp + 9)
    alt, nul = vk.scores_grid(**inp)
    P, B = 2, len(lens)
    pairs = dict(pidx=torch.arange(P, dtype=torch.int32, device=cuda),
                 tables=inp["tables"], tvecs=inp["tvecs"],
                 xts=inp["xts"].expand(P, B, 16).contiguous(),
                 lengths=inp["lengths"][:, None].expand(P, B, 1).contiguous(),
                 starts=inp["starts"].expand(P, B).contiguous(),
                 codes_all=inp["codes_all"])
    push = vk.scores_pairs if Kp <= vk.MAX_KP else vk.scores_pairs_large
    a1, n1 = push(**pairs)
    torch.cuda.synchronize()
    assert torch.equal(alt, a1) and torch.equal(nul, n1)


@pytest.mark.parametrize("Kp", [128, 2176])
def test_grid_chunks_bit_equal_to_one_launch(cuda, monkeypatch, Kp):
    """B9 over 8 profiles in launches of at most 3 (the card takes at most
    65535 on gridDim.y): bit-equal to one launch."""
    Ks = [Kp - 2, 17, 90, 64, 33, 100, 120, 7]
    inp = grid_inputs(cuda, Ks, Kp, [300, 1, 0, 45, 97], Kp + 11)
    alt, nul = vk.scores_grid(**inp)
    before = vk.LAUNCHES["grid"]
    monkeypatch.setattr(vk, "GRID_MAX_P", 3)
    a3, n3 = vk.scores_grid(**inp)
    assert vk.LAUNCHES["grid"] == before + 3
    torch.cuda.synchronize()
    assert alt.shape == (8, 5)
    assert torch.equal(a3, alt) and torch.equal(n3, nul)


# The amino kernels by Kpad band: 4 lanes a thread up to Kpad 2048 (one
# warp with idle threads below 128), 8 up to 8192 and 16 at 16384, the
# odds of the transition vectors in shared memory up to 4096 and in the
# launch's scratch past it.  They run in scaled odds space, the plain
# versions in log space as the reference; each kernel is held to its plain
# version evaluated in f64 (`exact`: the same function without the f32
# rounding that log space accumulates over a long hit) within the
# reference's own tolerance against brute force (tests/test_hmmer.py):
# rtol 1e-4, atol 1e-3, scores in bits.
AMINO_KPADS = [16, 32, 128, 1024, 2048, 4096, 8192, 16384]


def amino_args(Kpad, seed, device, lens=None):
    lens = lens or ([1, 37, 300] if Kpad <= 4096 else [1, 40])
    c = amino_hits(Kpad, lens, seed, device)
    return {k: c[k] for k in ("em", "tv", "res", "off", "xv")}, lens


def exact(plain, args):
    """A plain version on the f64 copy of the kernel's arguments."""
    return plain(**{k: v.double() if v.is_floating_point() else v
                    for k, v in args.items()}).float()


@pytest.mark.parametrize("Kpad", AMINO_KPADS)
def test_amino_forward_kernel_close_to_plain(cuda, Kpad):
    args, lens = amino_args(Kpad, Kpad + 5, cuda)
    before = vk.LAUNCHES["amino_forward"]
    got = hf.amino_forward(**args)
    assert vk.LAUNCHES["amino_forward"] == before + 1  # a batch, one launch
    want = exact(hf.amino_forward_plain, args)
    torch.cuda.synchronize()
    assert got.shape == (len(lens),) and torch.isfinite(got).all()
    torch.testing.assert_close(got / hf.LN2, want / hf.LN2, rtol=1e-4,
                               atol=1e-3)


@pytest.mark.parametrize("Kpad", AMINO_KPADS)
def test_amino_posterior_kernel_close_to_plain(cuda, Kpad):
    args, lens = amino_args(Kpad, Kpad + 6, cuda)
    before = vk.LAUNCHES["amino_posterior"]
    got = hf.amino_posterior(**args)
    assert vk.LAUNCHES["amino_posterior"] == before + 1
    want = exact(hf.amino_posterior_plain, args)
    torch.cuda.synchronize()
    assert got.shape == (len(lens), 3 + Kpad) and torch.isfinite(got).all()
    torch.testing.assert_close(got[:, 0] / hf.LN2, want[:, 0] / hf.LN2,
                               rtol=1e-4, atol=1e-3)
    torch.testing.assert_close(got[:, 1:], want[:, 1:], rtol=1e-4, atol=1e-3)
    # every residue is emitted by exactly one emitting state
    torch.testing.assert_close(got[:, 1:].sum(1).double(),
                               torch.tensor(lens, dtype=torch.float64,
                                            device=cuda), rtol=1e-4, atol=0)
    # the same Forward as the Forward kernel
    fwd = hf.amino_forward(**args)
    torch.testing.assert_close(got[:, 0] / hf.LN2, fwd / hf.LN2, rtol=1e-4,
                               atol=1e-3)


@pytest.mark.parametrize("Kpad", [16, 128, 2048, 8192])
def test_amino_batch_bit_equal_to_single_launches(cuda, Kpad):
    """A CTA's result depends on its own hit alone: a batch of hits of
    mixed L gives, row for row, the bits of each hit launched alone."""
    lens = [300, 1, 120, 37] if Kpad <= 2048 else [40, 1, 17]
    args, _ = amino_args(Kpad, Kpad + 7, cuda, lens)
    off = args["off"].tolist()
    for fn in (hf.amino_forward, hf.amino_posterior):
        batch = fn(**args)
        for h in range(len(lens)):
            one = fn(em=args["em"][h:h + 1], tv=args["tv"][h:h + 1],
                     res=args["res"][off[h]:off[h + 1]].contiguous(),
                     off=torch.tensor([0, lens[h]], dtype=torch.int32,
                                      device=cuda),
                     xv=args["xv"][h:h + 1])
            assert torch.equal(batch[h:h + 1], one), (fn.__name__, h)


def test_posterior_scratch_budget_split_bit_equal_on_card(cuda, monkeypatch):
    """A posterior Kpad group past a lowered POSTERIOR_SCRATCH_BYTES runs
    one launch a budget chunk, and its rows are bit-equal to the group in
    one launch."""
    from deciphon_tpu_torch.workload import peaked_hmm

    hmms = [peaked_hmm(500 + i, k) for i, k in enumerate((100, 30, 120, 90))]
    rng = np.random.default_rng(9)
    hits = [(p, "".join("ACDEFGHIKLMNPQRSTVWYX"[i]
                        for i in rng.integers(0, 21, size=n)))
            for p, n in ((0, 50), (1, 20), (2, 80), (3, 70), (0, 60))]
    sc = hf.AminoForwardScorer(hmms, device=cuda)
    before = vk.LAUNCHES["amino_posterior"]
    whole = sc.posterior_usages_many(hits)
    assert vk.LAUNCHES["amino_posterior"] == before + 2  # Kpad 128, 32
    monkeypatch.setattr(hf, "POSTERIOR_SCRATCH_BYTES",
                        hf.posterior_scratch_bytes(130, 128))
    assert sc.launch_plan(hits, posterior=True) == [[0, 2], [3, 4], [1]]
    before = vk.LAUNCHES["amino_posterior"]
    split = sc.posterior_usages_many(hits)
    assert vk.LAUNCHES["amino_posterior"] == before + 3
    for a, b in zip(whole, split):
        assert (a[0], a[2], a[3]) == (b[0], b[2], b[3])
        assert np.array_equal(a[1], b[1])


def test_amino_kernels_raise_on_bad_launch(cuda):
    args, _ = amino_args(128, 9, cuda)
    before = dict(vk.LAUNCHES)
    with pytest.raises(ValueError):  # mixed devices never fall back
        hf.amino_forward(**dict(args, res=args["res"].cpu()))
    with pytest.raises(NotImplementedError):  # Kpad not a power of two
        hf.amino_posterior(**dict(args, em=args["em"][:, :, :96].contiguous(),
                                  tv=args["tv"][:, :, :96].contiguous()))
    assert vk.LAUNCHES == before


def test_native_confirmer_on_card_matches_cpu(cuda):
    """NativeConfirmer on the card (the posterior kernel, null2) against
    the same confirmer on the CPU: the same keep decision as the plain
    versions in f32, log-E and bit score within the stated tolerance of
    the plain versions evaluated in f64 (on the 700-residue hit the f32
    log-space plain versions stray 0.48 nats of null2 bias from it), the
    same blob fields; one confirm_many call gives the answers of the
    calls hit by hit."""
    from deciphon_tpu_torch.hmmer.h3result import H3Result
    from deciphon_tpu_torch.workload import exact_confirmer, peaked_hmm

    hmms = [peaked_hmm(300 + i, k) for i, k in enumerate((40, 130, 700))]
    rng = np.random.default_rng(4)
    seqs = []
    for h in hmms:  # each profile's argmax residues, then a random string
        seqs.append("".join("ACDEFGHIKLMNPQRSTVWY"[i]
                            for i in h.match_lprobs.argmax(1)))
        seqs.append("".join("ACDEFGHIKLMNPQRSTVWYX"[i]
                            for i in rng.integers(0, 21, size=60)))
    card = hf.NativeConfirmer(hmms, device=cuda)
    cpu = hf.NativeConfirmer(hmms, device="cpu")
    f64 = exact_confirmer(hmms)
    hits = [(p, q) for p in range(len(hmms)) for q in seqs[2 * p: 2 * p + 2]]
    before = vk.LAUNCHES["amino_posterior"]
    many = card.confirm_many(hits)
    assert vk.LAUNCHES["amino_posterior"] == before + 3  # Kpad 64, 256, 1024
    kept = 0
    for (p, q), (lg, bg) in zip(hits, many):
        assert (lg, bg) == card.confirm(p, q)
        (lc, bc), (le, be) = cpu.confirm(p, q), f64.confirm(p, q)
        assert (bg is None) == (bc is None) == (be is None)
        assert (lg == 0) == (lc == 0)
        assert lg == pytest.approx(le, rel=1e-4, abs=1e-3)
        if bg is not None:
            kept += 1
            hg, he = H3Result.from_blob(bg), H3Result.from_blob(be)
            assert hg.hits[0].acc == he.hits[0].acc
            assert hg.hits[0].score == pytest.approx(he.hits[0].score,
                                                     rel=1e-4, abs=1e-3)
    assert kept >= 3  # the argmax strings confirm


def test_confirmed_scan_batched_on_card(cuda, tmp_path):
    """confirm_case on the card: the batched route (NativeConfirmer's
    bound confirm) and the hit-by-hit route write the same bytes; the
    batched route launches the posterior once per (wave, Kpad) group, the
    hit-by-hit route once per non-empty hit."""
    from deciphon_tpu_torch.workload import confirm_case

    hmms, profiles, seqs = confirm_case()
    conf = hf.NativeConfirmer(hmms, device=cuda)
    waves = []

    class Batched:
        def confirm_many(self, hits):
            waves.append(list(hits))
            return conf.confirm_many(hits)

        def __call__(self, p_idx, amino_seq):
            raise AssertionError("the batched route called hit by hit")

    out, launches = {}, {}
    for name, confirmer in (("batched", Batched()),
                            ("single", lambda p, q: conf.confirm(p, q))):
        vk.reset_launches()
        sc = tp.Scanner(profiles, tp.ScanConfig(device="cuda"),
                        confirmer=confirmer)
        root = tmp_path / name
        sc.run(seqs, str(root))
        out[name] = {str(f.relative_to(root)): f.read_bytes()
                     for f in sorted(root.rglob("*")) if f.is_file()}
        launches[name] = vk.LAUNCHES["amino_posterior"]
    assert out["batched"] == out["single"]
    assert any(k.endswith(".h3r") for k in out["batched"])
    groups = sum(len(conf.scorer.launch_plan([h for h in w if h[1]], True))
                 for w in waves)
    assert launches["batched"] == groups < launches["single"]
    assert launches["single"] == sum(1 for w in waves for _, q in w if q)


# The redesigned B1/B3/B5/B8 body and B2 choose lanes a thread by Kp band:
# the score body 2 up to 512 and 4 up to 2048, B2 2 up to 1024 and 4 up to
# 2048, a thread-block cluster at 4 past it (2176).  Window lengths 1-12 cover every
# phase of the 5-position unroll with the codes fetched two positions
# ahead running past the window's end; 41 and 300 run many rounds.
BAND_KPS = [128, 512, 640, 1024, 1152, 2048, 2176]
SHORT_LENS = [[1, 2, 3, 4, 5, 6, 0, 300], [7, 8, 9, 10, 11, 12, 41, 0]]


@pytest.mark.parametrize("ties", [False, True])
@pytest.mark.parametrize("Kp", BAND_KPS)
def test_score_bands_bit_equal_to_plain(cuda, Kp, ties):
    inp = inputs(cuda, [Kp - 2, 17], Kp, SHORT_LENS, seed=Kp + 11, ties=ties)
    alt, nul = vk.scores_pairs(**inp)
    pa, pn = vk.scores_pairs_plain(**inp)
    torch.cuda.synchronize()
    assert torch.equal(alt, pa) and torch.equal(nul, pn)


@pytest.mark.parametrize("ties", [False, True])
@pytest.mark.parametrize("Kp", BAND_KPS + [2816])
def test_path_bands_bit_equal_to_plain(cuda, Kp, ties):
    """Every trellis word of windows of 1-12, 41 and 300 positions; with
    `ties` on a profile whose candidates tie nearly everywhere, so the
    first-minimum order decides the words."""
    inp = inputs(cuda, [Kp - 2, 17], Kp, SHORT_LENS, seed=Kp + 13, ties=ties)
    nlb = -(-300 // vk.PATH_KAPPA)
    xn, nd = vk.paths_pairs(**inp, nlb=nlb)
    px, pd = vk.paths_pairs_plain(**inp, nlb=nlb)
    torch.cuda.synchronize()
    for n, row in enumerate(SHORT_LENS):
        for w, L in enumerate(row):
            assert torch.equal(xn[n, w, :L], px[n, w, :L]), (n, w)
            assert torch.equal(nd[n, w, :L], pd[n, w, :L]), (n, w)


@pytest.mark.parametrize("Kp", [1152, 2048, 2176])
def test_chained_mixed_carry_bands_bit_equal_to_plain(cuda, Kp):
    """B3, B5 and B8 on the bands past the first (the earlier tests take
    128, 1024 and 5120)."""
    inp = chain_case(Kp, seed=Kp, device=cuda, lo=1, hi=60)
    got = vk.scores_pairs_chained(**inp)
    want = vk.scores_pairs_chained_plain(**inp)
    inp = mixed_case(Kp, seed=Kp + 2, device=cuda, hi=300)
    got += vk.scores_pairs_mixed(**inp)
    want += vk.scores_pairs_mixed_plain(**inp)
    torch.cuda.synchronize()
    assert all(torch.equal(a, b) for a, b in zip(got, want))
    case = carry_case(Kp, seed=Kp + 3, device=cuda)
    got = run_carry_calls(vk.scores_pairs_chained_carry, case)
    want = run_carry_calls(vk.scores_pairs_chained_carry_plain, case)
    torch.cuda.synchronize()
    last = len(got) - 1
    for t, (g, w) in enumerate(zip(got, want)):
        for slot in ([0, 1] if t == last else [1]):
            assert torch.equal(g[0][0, slot, 0], w[0][0, slot, 0]), (t, slot)
            assert torch.equal(g[1][0, slot, 0], w[1][0, slot, 0]), (t, slot)
        if t < last:  # the continuing slot's exported planes
            assert torch.equal(g[2][:, :, 0], w[2][:, :, 0])
            assert torch.equal(g[3][:, :, 0], w[3][:, :, 0])


# The mid-K band: B1, B3, B5 and B8 past Kp 2048 on thread-block clusters
# (the score body's `cluster_shape`), at the first clustered width, a
# mid-band one and the widest plain bucket (10 CTAs of 512 lanes).
MIDK_KPS = [2176, 3072, 5120]


@pytest.mark.parametrize("Kp", MIDK_KPS)
def test_midk_kernels_bit_equal_to_plain(cuda, Kp):
    """B1 (windows of 1-12, 41 and 300 positions and pads), B3 (chains of
    up to 4 windows and an all-pad pair), B5 and B8 (a window over 4 carry
    calls, a normal window riding in a spare slot) against their plain
    versions, each launched on a cluster of c > 1 CTAs."""
    got, want = [], []
    inp = inputs(cuda, [Kp - 2, 17], Kp, SHORT_LENS, seed=Kp + 31)
    got += vk.scores_pairs(**inp)
    want += vk.scores_pairs_plain(**inp)
    inp = chain_case(Kp, seed=Kp + 33, device=cuda, lo=1, hi=200)
    got += vk.scores_pairs_chained(**inp)
    want += vk.scores_pairs_chained_plain(**inp)
    assert torch.isinf(got[-2][-1]).all()  # the all-pad pair
    inp = mixed_case(Kp, seed=Kp + 35, device=cuda, hi=300)
    got += vk.scores_pairs_mixed(**inp)
    want += vk.scores_pairs_mixed_plain(**inp)
    case = carry_case(Kp, seed=Kp + 37, device=cuda)
    for g, w in zip(run_carry_calls(vk.scores_pairs_chained_carry, case),
                    run_carry_calls(vk.scores_pairs_chained_carry_plain,
                                    case)):
        got += [g[0], g[1], g[2][:, :, 0], g[3][:, :, 0]]
        want += [w[0], w[1], w[2][:, :, 0], w[3][:, :, 0]]
    torch.cuda.synchronize()
    for i, (a, b) in enumerate(zip(got, want)):
        assert torch.equal(a, b), i
    for key in ("score", "chain", "gang", "carry"):
        shape = vk.SHAPES[(key, Kp)]
        assert shape["c"] == vk.cluster_shape(Kp).c > 1, key
        assert shape["active"] > 0, key


@pytest.mark.parametrize("Kp", MIDK_KPS)
def test_midk_large_wrappers_bit_equal_to_plain(cuda, Kp):
    """B4 and B4m, the wrappers that share B1's and B5's launchers,
    against their plain versions on the windows that
    test_midk_kernels_bit_equal_to_plain gives B1 and B5, each on a
    cluster."""
    inp = inputs(cuda, [Kp - 2, 17], Kp, SHORT_LENS, seed=Kp + 31)
    got = list(vk.scores_pairs_large(**inp))
    want = list(vk.scores_pairs_plain(**inp))
    inp = mixed_case(Kp, seed=Kp + 35, device=cuda, hi=300)
    got += vk.scores_pairs_mixed_large(**inp)
    want += vk.scores_pairs_mixed_plain(**inp)
    torch.cuda.synchronize()
    for i, (a, b) in enumerate(zip(got, want)):
        assert torch.equal(a, b), i
    for key in ("large", "gang_large"):
        assert vk.SHAPES[(key, Kp)]["c"] == vk.cluster_shape(Kp).c > 1, key


def test_kernels_raise_on_bad_launch(cuda, monkeypatch):
    inp = inputs(cuda, [9], 128, [[10]], seed=3)
    with pytest.raises(ValueError):  # mixed devices never fall back
        vk.scores_pairs(**dict(inp, starts=inp["starts"].cpu()))
    # a packed plane outside the accepted set (segments of 32 lanes)
    inp = packed_case(64, 2, seed=5, device=cuda, n_pairs=1, w=2, lo=20,
                      hi=50)
    with pytest.raises(NotImplementedError):
        vk.scores_pairs_packed(**dict(inp, nseg=4))
    # shapes the launchers refuse: 8 lanes a thread, threads that do not
    # cover the plane, shared bytes of another body
    before = dict(vk.LAUNCHES)
    chain = packed_chain_case(64, 2, seed=6, device=cuda, n_pairs=1, lo=40,
                              hi=80)
    Kp = 128
    for bad in (vk.PackedShape(8, Kp // 8, vk.PACKED_PLANES * Kp * 4),
                vk.PackedShape(2, Kp // 4, vk.PACKED_PLANES * Kp * 4),
                vk.PackedShape(2, Kp // 2, vk.SCORE_PLANES * Kp * 4 + 4)):
        monkeypatch.setattr(vk, "packed_shape", lambda Kp, nseg, b=bad: b)
        with pytest.raises(RuntimeError, match="CUDA error"):
            vk.scores_pairs_packed(**inp)
        with pytest.raises(RuntimeError, match="CUDA error"):
            vk.scores_pairs_packed_chained(**chain)
    assert vk.LAUNCHES == before  # a refused launch is not counted


@pytest.mark.parametrize("tier", ["chain", "chain+gang", "chain+seg",
                                  "classic", "large", "torch", "streamed"])
def test_scan_on_card_matches_cpu(cuda, tmp_path, monkeypatch, tier):
    """Each phase-1 tier on the card writes the CPU's products; the
    shrunk caps send the 900-nt read's windows over the chain cap, and
    a plain-bucket cap of 64 lanes sends every profile to the large-K
    tier; engine="torch" on the card writes the kernels' bytes on the
    CPU; a table budget of 1 byte streams every scorer's tables, and its
    gang runs B4m."""
    if tier == "streamed":
        monkeypatch.setenv("DECIPHON_HBM_BUDGET", "1")
    if tier == "large":
        monkeypatch.setattr(ts.BucketedPairScorer, "MAX_KP", 64)
        monkeypatch.setattr(ts.BucketedPairScorer, "PACK_MAX_SEG", 0)
    elif tier != "chain":
        monkeypatch.setattr(ts.PairScorer, "CHAIN_MAX_BLK", 4)
        monkeypatch.setattr(ts.PairScorer, "NLB_FLOOR", 4)
    if tier == "chain+seg":
        monkeypatch.setenv("DECIPHON_CHAIN_SEG", "1")
    if tier == "classic":
        monkeypatch.setenv("DECIPHON_NO_CHAIN", "1")
    profiles = [sample_profile(140, 40), sample_profile(250, 150),
                sample_profile(109, 9)]
    rng = np.random.default_rng(7)
    reads = [planted_read(rng, profiles[0], 300),
             planted_read(rng, profiles[1], 900, noise=0.01),
             random_bases(rng, 250), random_bases(rng, 150)]
    seqs = [Sequence.make(i, f"r{i}", r) for i, r in enumerate(reads)]
    out = {}
    for dev in ("cuda", "cpu"):
        engine = "torch" if tier == "torch" and dev == "cuda" else "kernels"
        sc = tp.Scanner(profiles, tp.ScanConfig(device=dev, engine=engine))
        vk.reset_launches()
        with open(sc.run(seqs, str(tmp_path / dev))) as fp:
            out[dev] = fp.read()
        assert sc.metrics.survivors > 0
        if tier == "streamed" and dev == "cuda":
            assert all(s.stream_tables for s in sc.scorer.scorers)
            assert vk.LAUNCHES["gang_large"] > 0
            assert vk.LAUNCHES["gang"] == 0
    assert out["cuda"] == out["cpu"]


# The clustered kernels (B4, B4m, B2 past Kp 2048): a window on a cluster of
# `cluster_shape(Kp).c` CTAs.  CLUSTER_KPS are the widths the scans reach
# (and 2176, the first clustered one); the edges are the first and the last
# Kp of every cluster size the shape function picks, so that every shape
# the launchers can take runs.  SHORT_LENS puts length-0 windows in every
# launch.
CLUSTER_KPS = [2176, 2816, 3072, 5376, 5632, 8704, 16896]


def cluster_edges(body):
    """Both sides of every change of cluster size over the clustered
    widths, and the first and the last of them."""
    kps = list(range(2176, vk.MAX_LARGE_KP + 1, 128))
    c = [vk.cluster_shape(Kp, body).c for Kp in kps]
    edges = {kps[0], kps[-1]}
    for i in range(1, len(kps)):
        if c[i] != c[i - 1]:
            edges |= {kps[i - 1], kps[i]}
    return sorted(edges)


def cluster_cases(body):
    """(Kp, ties): both at CLUSTER_KPS, ties=False at the other edges."""
    return ([(Kp, t) for Kp in CLUSTER_KPS for t in (False, True)]
            + [(Kp, False) for Kp in cluster_edges(body)
               if Kp not in CLUSTER_KPS])


def mixed_inputs(dev, Ks, Kp, lens, seed, ties=False):
    """inputs() with one profile per (pair, slot), neighbours differing."""
    inp = inputs(dev, Ks, Kp, lens, seed, ties)
    N, W = inp["starts"].shape
    inp["pidx"] = torch.tensor([[(n + w) % len(Ks) for w in range(W)]
                                for n in range(N)], dtype=torch.int32,
                               device=dev)
    return inp


@pytest.mark.parametrize("Kp,ties", cluster_cases("score"))
def test_large_cluster_bands_bit_equal_to_plain(cuda, Kp, ties):
    inp = inputs(cuda, [Kp - 2, 17], Kp, SHORT_LENS, seed=Kp + 17, ties=ties)
    before = vk.LAUNCHES["large"]
    alt, nul = vk.scores_pairs_large(**inp)
    assert vk.LAUNCHES["large"] == before + 1
    shape = vk.SHAPES[("large", Kp)]
    assert shape["c"] == vk.cluster_shape(Kp).c > 1 and shape["active"] > 0
    pa, pn = vk.scores_pairs_plain(**inp)
    torch.cuda.synchronize()
    assert torch.equal(alt, pa) and torch.equal(nul, pn)
    assert torch.isinf(alt[0, 6]) and torch.isfinite(alt[0, 7])


@pytest.mark.parametrize("Kp,ties", cluster_cases("score"))
def test_mixed_large_cluster_bands_bit_equal_to_plain_and_b5(cuda, Kp, ties):
    """B4m on clusters: its plain version, and B5 where B5 takes the
    width (up to Kp 5120)."""
    inp = mixed_inputs(cuda, [Kp - 2, Kp // 2, 17], Kp, SHORT_LENS,
                       seed=Kp + 19, ties=ties)
    before = vk.LAUNCHES["gang_large"]
    alt, nul = vk.scores_pairs_mixed_large(**inp)
    assert vk.LAUNCHES["gang_large"] == before + 1
    assert vk.SHAPES[("gang_large", Kp)]["c"] > 1
    pa, pn = vk.scores_pairs_mixed_plain(**inp)
    torch.cuda.synchronize()
    assert torch.equal(alt, pa) and torch.equal(nul, pn)
    if Kp <= vk.MAX_KP:
        ba, bn = vk.scores_pairs_mixed(**inp)
        torch.cuda.synchronize()
        assert torch.equal(alt, ba) and torch.equal(nul, bn)


def check_paths_and_walk(dev, inp, lens):
    """B2 against its plain version on every real window's rows, and the
    walk of those windows against the plain walk."""
    L = max(max(r) for r in lens)
    nlb = -(-L // vk.PATH_KAPPA)
    xn, nd = vk.paths_pairs(**inp, nlb=nlb)
    px, pd = vk.paths_pairs_plain(**inp, nlb=nlb)
    torch.cuda.synchronize()
    for n, row in enumerate(lens):
        for w, L in enumerate(row):
            assert torch.equal(xn[n, w, :L], px[n, w, :L]), (n, w)
            assert torch.equal(nd[n, w, :L], pd[n, w, :L]), (n, w)
    N, W, Lk, Kp = nd.shape
    flat = [L for row in lens for L in row]
    rows = [i for i, L in enumerate(flat) if L > 0]
    xnf, ndf = xn.reshape(N * W, Lk), nd.reshape(N * W, Lk, Kp)
    r = torch.tensor(rows, dtype=torch.int32, device=dev)
    lt = torch.tensor([flat[i] for i in rows], dtype=torch.int32, device=dev)
    steps = Lk + 4 * Kp + 64
    got = tb.walk(xnf, ndf, r, lt, steps)
    want = tb.walk_plain(xnf, ndf, r, lt, steps)
    torch.cuda.synchronize()
    assert all(torch.equal(a, b) for a, b in zip(got, want))
    assert got[3].all()
    return px


@pytest.mark.parametrize("Kp,ties", cluster_cases("score"))
def test_grid_cluster_bands_bit_equal_to_plain(cuda, Kp, ties):
    """B9 on clusters at both sides of every change of cluster size: two
    profiles against the windows of SHORT_LENS (pads among them)."""
    lens = [L for row in SHORT_LENS for L in row]
    inp = grid_inputs(cuda, [Kp - 2, 17], Kp, lens, Kp + 31)
    if ties:
        costs = [tied(build_costs(sample_profile(Kp + 31 + i, k)))
                 for i, k in enumerate((Kp - 2, 17))]
        inp["tables"], inp["tvecs"] = (t.to(cuda) for t in
                                       stack_tables(costs, Kp))
    alt, nul = vk.scores_grid(**inp)
    assert vk.SHAPES[("grid", Kp)]["c"] == vk.cluster_shape(Kp).c > 1
    pa, pn = vk.scores_grid_plain(**inp)
    torch.cuda.synchronize()
    assert torch.equal(alt, pa) and torch.equal(nul, pn)
    assert torch.isinf(alt[:, lens.index(0)]).all()


@pytest.mark.parametrize("Kp,ties", cluster_cases("path"))
def test_path_cluster_bands_bit_equal_to_plain(cuda, Kp, ties):
    inp = inputs(cuda, [Kp - 2, 17], Kp, SHORT_LENS, seed=Kp + 23, ties=ties)
    before = vk.LAUNCHES["path"]
    check_paths_and_walk(cuda, inp, SHORT_LENS)
    assert vk.LAUNCHES["path"] == before + 1
    shape = vk.SHAPES[("path", Kp)]
    assert shape["c"] == vk.cluster_shape(Kp, "path").c > 1
    assert shape["active"] > 0


@pytest.mark.parametrize("rank", [1, 2])
def test_path_e_tie_across_cta_boundary(cuda, rank):
    """B->M entries only at the last lane of rank `rank` - 1 and the
    first lane of rank `rank`, at equal cost on a profile whose costs tie:
    E's minimum is taken at both, and its field must name the earlier
    lane (the first minimum), as the plain version does."""
    Kp = 5376
    w = vk.cluster_shape(Kp, "path").w
    k1 = rank * w - 1
    costs = tied(build_costs(sample_profile(Kp, Kp - 2)))
    bm = np.full_like(costs.core[CT_DD], np.inf)
    bm[[k1, k1 + 1]] = 0.5
    costs.core[CT_BM] = bm
    tables, tvecs = (t.to(cuda) for t in stack_tables([costs], Kp))
    lens = [[3, 0, 40, 7]]
    inp = dict(pidx=torch.zeros(1, dtype=torch.int32, device=cuda),
               tables=tables, tvecs=tvecs,
               **window_batch(np.random.default_rng(5),
                              np.asarray(lens, np.int32), cuda))
    px = check_paths_and_walk(cuda, inp, lens)
    e_lane = (px[0, 0, :3] >> 6) & 0x7fff
    assert (e_lane == 2 * k1).any()  # the tie happened and went to k1


@pytest.mark.parametrize("Kp", [5376, 16896])
def test_clustered_launch_of_pads_only(cuda, Kp):
    """A launch whose windows are all of length 0: B4, B4m and B9 write
    +inf, B2 writes no row, and every rank leaves before any cluster
    barrier."""
    lens = [[0, 0, 0], [0, 0, 0]]
    inp = inputs(cuda, [Kp - 2, 17], Kp, lens, seed=Kp + 29)
    alt, nul = vk.scores_pairs_large(**inp)
    ma, mn = vk.scores_pairs_mixed_large(**mixed_inputs(
        cuda, [Kp - 2, 17], Kp, lens, seed=Kp + 29))
    xn, nd = vk.paths_pairs(**inp, nlb=1)
    ga, gn = vk.scores_grid(**grid_inputs(cuda, [Kp - 2, 17], Kp, lens[0],
                                          Kp + 29))
    torch.cuda.synchronize()
    for t in (alt, nul, ma, mn, ga.reshape(2, 3), gn.reshape(2, 3)):
        assert t.shape == (2, 3) and torch.isinf(t).all()
    assert xn.shape == (2, 3, vk.PATH_KAPPA)


@pytest.mark.parametrize("Kp,Lk", [(256, 1024), (1024, 4096), (37, 301)])
def test_walk_kernel_on_walk_cases(cuda, Kp, Lk):
    """The walk kernel on the planted edge cases (16-byte copies, and
    4-byte ones at the torch engine's layout): bit-equal to the plain walk;
    every walk that ends, the overflow after its re-walk on the card,
    equal to its planted path; the underflow raises in rewalk."""
    c = walk_cases(Kp, Lk, seed=Kp + Lk, device=cuda)
    args = [c[k] for k in ("xn", "nd", "rows", "lengths")]
    before = vk.LAUNCHES["walk"]
    got = tb.walk(*args, c["max_steps"])
    assert vk.LAUNCHES["walk"] == before + 1
    want = tb.walk_plain(*args, c["max_steps"])
    torch.cuda.synchronize()
    assert all(torch.equal(a, b) for a, b in zip(got, want))
    names = c["names"]
    for n, ok in zip(names, got[3].tolist()):
        assert bool(ok) == (n not in ("overflow", "underflow", "empty")), n
    tb.REWALKS["survivors"] = 0
    out = assemble_walk_cases(c, got)
    assert tb.REWALKS["survivors"] == 1  # the overflow, on the card
    assert len(out) == len(names) - 2  # all but the underflow and empty
    for b, path in out.items():
        for x, y in zip(path, tb.path_arrays(c["paths"][b])):
            assert np.array_equal(x, y), names[b]
    b = names.index("underflow")
    with pytest.raises(RuntimeError, match="underflow"):
        tb.rewalk(c["xn"], c["nd"], [int(c["rows"][b])], [2],
                  c["max_steps"])



# Shards (parallel/multidevice.py): two shards on one card, and a shard on
# a second card, against one device on the same items.  Each profile has a
# 150-nt read (it pins a chain cap of 4 blocks under the shrunk caps) and
# one longer read of its own length, so that under DECIPHON_CHAIN_SEG=1 the
# profiles' windows split into different numbers of carry segments and
# later segment chunks route rows from one shard to another.

SHARD_READS = (1000, 250, 900, 800, 1200, 1100)


def shard_case(dev, tier, monkeypatch):
    """(make, items, codes) of a tier: "score" (B1 under
    DECIPHON_NO_CHAIN=1), "chain" (B3), "pchain" (B7, a packed class) or
    "carry" (B8, caps shrunk to 4 blocks); make(mesh) builds its scorer,
    on `dev` alone for mesh None."""
    from deciphon_tpu_torch.parallel import multidevice as md
    from deciphon_tpu_torch.scan.window import Window

    if tier == "score":
        monkeypatch.setenv("DECIPHON_NO_CHAIN", "1")
    if tier == "carry":
        monkeypatch.setattr(ts.PairScorer, "CHAIN_MAX_BLK", 4)
        monkeypatch.setattr(ts.PairScorer, "NLB_FLOOR", 4)
        monkeypatch.setenv("DECIPHON_CHAIN_SEG", "1")
    ks = (9, 11, 14, 17, 20, 24)
    costs = [build_costs(sample_profile(300 + i, k))
             for i, k in enumerate(ks)]
    rng = np.random.default_rng(5)
    lens = [150] + list(SHARD_READS)
    seqs = [Sequence.make(i, f"s{i}", random_bases(rng, n))
            for i, n in enumerate(lens)]
    codes = ts.DeviceSeqCodes(seqs, dev)
    items = [ts.PairItem(p, i, Window(0, 0, seqs[i].size), True, False,
                         seq=seqs[i], gstart=codes.gstart(i, 0))
             for p in range(len(ks)) for i in (0, p + 1)]

    def make(mesh):
        if tier == "pchain":
            if mesh is None:
                return ts.PackedPairScorer(costs, 2, dev, seg=64)
            return md.MultiDevicePackedScorer(costs, 2, mesh=mesh, seg=64)
        if mesh is None:
            return ts.PairScorer(costs, dev, w=8)
        return md.MultiDevicePairScorer(costs, mesh=mesh, w=8)

    return make, items, codes


def shard_scores(scorer, items, codes):
    """(scores {id: (null, alt)}, launches by key) of one dispatch."""
    scorer.set_device_codes(codes)
    before = dict(vk.LAUNCHES)
    got = scorer.score(items)
    return got, {k: v - before[k] for k, v in vk.LAUNCHES.items()
                 if v != before[k]}


def check_shards(make, items, codes, mesh, tier):
    """The sharded scorer's planes equal the one-device scorer's bit for
    bit, each launch becomes one launch a shard, and (carry) rows cross
    shards."""
    from deciphon_tpu_torch.parallel import multidevice as md

    want, n1 = shard_scores(make(None), items, codes)
    md.reset_shard_launches()
    got, n2 = shard_scores(make(mesh), items, codes)
    assert got == want  # float equality of every (null, alt) pair
    key = {"score": "score", "chain": "chain", "pchain": "pchain",
           "carry": "carry"}[tier]
    assert n1[key] > 0 and n2[key] == len(mesh) * n1[key]
    if tier == "carry":
        assert md.ROUTED["cross"] > 0, "no carry row crossed shards"


@pytest.mark.parametrize("tier", ["score", "chain", "pchain", "carry"])
def test_two_shards_on_one_card_bit_equal_to_one(cuda, monkeypatch, tier):
    """B1, B3, B7 and B8 (rows routed across shards) split over two
    shards on cuda:0, each on its own stream: the same planes as one
    device."""
    make, items, codes = shard_case(cuda, tier, monkeypatch)
    check_shards(make, items, codes, ["cuda:0", "cuda:0"], tier)


@pytest.mark.skipif(torch.cuda.device_count() < 2,
                    reason="needs two CUDA devices")
@pytest.mark.parametrize("tier", ["score", "carry"])
def test_shard_on_second_card(cuda, monkeypatch, tier):
    """A launch on cuda:1 tensors runs on cuda:1 (each launcher enters its
    tensors' device) and equals cuda:0's; a scorer over (cuda:0, cuda:1)
    equals one device, B8's carry rows crossing between the cards."""
    inp = inputs(torch.device("cuda:0"), [40, 17], 128,
                 [[300, 1, 0, 45], [81, 0, 0, 0]], seed=3)
    a0 = vk.scores_pairs(**inp)
    a1 = vk.scores_pairs(**{k: v.to("cuda:1") for k, v in inp.items()})
    assert torch.cuda.current_device() == 0
    assert a1[0].device == torch.device("cuda:1")
    assert all(torch.equal(x, y.to("cuda:0")) for x, y in zip(a0, a1))
    make, items, codes = shard_case(torch.device("cuda:0"), tier,
                                    monkeypatch)
    check_shards(make, items, codes, ["cuda:0", "cuda:1"], tier)


def test_card_worker_job_equals_cpu_worker(cuda, tmp_path):
    """A scan job run by a worker on the card gives the snap a worker on
    the CPU gives for the same job (press on the host; the scheduler, the
    client and both workers in process)."""
    import zipfile

    from deciphon_tpu_torch.io.dcp import read_dcp_profiles
    from deciphon_tpu_torch.poster import Poster
    from deciphon_tpu_torch.sched import SchedServer, SchedSettings
    from deciphon_tpu_torch.worker_daemon import WorkerLoop
    from deciphon_tpu_torch.workload import (hmm_text, peaked_hmm,
                                             planted_read, random_bases,
                                             sample_hmm)

    (tmp_path / "db.hmm").write_text(hmm_text(
        [peaked_hmm(40, 9), sample_hmm(41, 50)[0], peaked_hmm(42, 95)]))
    settings = SchedSettings(host="127.0.0.1", port=0,
                             data_dir=str(tmp_path / "sched"))
    snaps = {}
    with SchedServer(settings) as server:
        poster = Poster(server.url)
        poster.upload("hmms", str(tmp_path / "db.hmm"))
        poster.hmm_post("db.hmm", gencode=1)
        loops = {dev: WorkerLoop(Poster(server.url),
                                 workdir=str(tmp_path / dev), device=dev)
                 for dev in ("cuda", "cpu")}
        assert loops["cpu"].poll_once(timeout=0)
        _, profiles = read_dcp_profiles(str(tmp_path / "cpu" / "db.dcp"))
        rng = np.random.default_rng(5)
        seqs = [{"name": f"r{i}", "data": r} for i, r in enumerate((
            planted_read(rng, profiles[2], 400, noise=0.01),
            planted_read(rng, profiles[0], 200, noise=0.01),
            random_bases(rng, 300)))]
        db_id = poster.db_list()[0]["id"]
        for dev, loop in loops.items():
            vk.reset_launches()
            scan = poster.scan_post(db_id, seqs)
            assert loop.poll_once(timeout=0)
            assert poster.job_get(scan["job"]["id"])["state"] == "done"
            if dev == "cuda":
                assert vk.LAUNCHES["path"] > 0 and vk.LAUNCHES["walk"] > 0
            with zipfile.ZipFile(io.BytesIO(poster.snap_get(scan["id"]))) as z:
                snaps[dev] = {n.split("/", 1)[1]: z.read(n)
                              for n in z.namelist() if not n.endswith("/")}
            poster.scan_delete(scan["id"])  # the next scan's ids start at 1
    assert snaps["cuda"] == snaps["cpu"]
    assert snaps["cuda"]["products.tsv"].count(b"\n") > 1
