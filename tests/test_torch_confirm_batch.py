"""Batched confirmation in the port, and a CPU model of the amino kernels'
arithmetic.

The batched route: `Scanner` hands a wave's hits to a confirmer's
`confirm_many` in one call (NativeConfirmer groups them by Kpad, one
launch a group); any other callable is called hit by hit.  Both routes
write the same bytes, and every products.tsv column but the e-value is
the reference's (`engine="jax"` with its native confirmer).

The model: `scaled_odds` below is the arithmetic of
csrc/amino_forward.cu in numpy f32, vectorised over the lanes: the
Forward and Backward in odds space, the D chains as affine scans of
pairs (a, g), each row carried to the next position scaled by the power
of two 2^-e of its specials' total (the e summed exactly), and the usages
f b r_l / Q.  It is held to `_jit_forward` / `_jit_posterior` and to the
port's plain versions within rtol 1e-4, atol 1e-3 (the reference's own
tolerance against brute force; scores in bits, usages absolute).  Those
two run in f32 log space, whose rounding grows with the hit: on a peaked
hit of 700 residues (a Forward of 1534 nats) they stray 1.1e-2 from the
plain versions evaluated in f64, past the tolerance, while the model stays
within 4e-5; there the model is held to the f64 evaluation.
"""

import math

import numpy as np
import pytest
import torch

import deciphon_tpu.hmmer.forward as r_forward
from deciphon_tpu.scan import pipeline as r_pipeline
import deciphon_tpu_torch.hmmer.forward as p_forward
from deciphon_tpu_torch.scan import pipeline as p_pipeline
from deciphon_tpu_torch.workload import (exact_confirmer, peaked_hmm,
                                         sample_hmm)
from test_torch_hmmer import (AMINO, ATOL, RTOL, BatchRecorder,
                              amino_string, assert_blobs_close,
                              lines_but_evalue, scan_dir, to_ref)
from test_torch_hmmer import case  # noqa: F401  (the scan tests' fixture)

torch.set_num_threads(1)  # see test_torch_hmmer

f32 = np.float32
F = p_forward


# ---------------------------------------------------------------------------
# the model
# ---------------------------------------------------------------------------


def _scan_up(a, g):
    """Inclusive affine scan: lane k gets the composition of the maps
    x -> a[j] + g[j] x of lanes 0..k applied to 0 (Hillis-Steele, as a
    warp shuffle scan)."""
    a, g = a.copy(), g.copy()
    o = 1
    while o < len(a):
        a[o:], g[o:] = a[o:] + g[o:] * a[:-o], g[o:] * g[:-o]
        o *= 2
    return a


def _scan_down(a, g):
    """The same over lanes k..K-1 (a suffix)."""
    return _scan_up(a[::-1].copy(), g[::-1].copy())[::-1].copy()


def _next(x):  # out[k] = x[k + 1], 0 past the last lane
    return np.concatenate([x[1:], np.zeros(1, f32)])


def scaled_odds(em, tv, seq, x, post: bool):
    """One hit in the kernels' arithmetic: the Forward nats, and with
    `post` the row (fwd, gI, gNCJ, gM...) of amino_posterior."""
    odds = lambda v: np.exp(np.asarray(v, f32)).astype(f32)
    tmm, tim, tmi, tii, tbm = (odds(tv[i]) for i in (
        F.TV_MM, F.TV_IM, F.TV_MI, F.TV_II, F.TV_BM))
    dv = (np.asarray(tv[F.TV_DV]) > 0).astype(f32)
    tdm = odds(tv[F.TV_DM]) * dv  # D lanes 1..K-1 only
    tmdn, tddn = _next(odds(tv[F.TV_MD])), _next(odds(tv[F.TV_DD]))
    xo = odds(x)
    Kpad = len(tmm)
    M = np.zeros(Kpad, f32)
    I, D = M.copy(), M.copy()
    N, B, E, J, C, r = f32(1), xo[F.X_NB], f32(0), f32(0), f32(0), f32(1)
    esum, rows = 0, []
    for s in seq:
        # r: the previous row's scale, applied as the row is carried
        inn = M * tmm + I * tim + D * tdm
        shifted = np.concatenate([np.zeros(1, f32), inn[:-1]])
        M, I = (odds(em[s]) * (shifted * r + B * r * tbm),
                (M * tmi + I * tii) * r)
        # d[k + 1] = M[k] tmd[k + 1] + tdd[k + 1] d[k], d[0] = 0
        D = np.concatenate([np.zeros(1, f32), _scan_up(M * tmdn, tddn)[:-1]])
        En = M.sum(dtype=f32) + D.sum(dtype=f32)
        Nn = N * r * xo[F.X_NN]
        Jn = (E * xo[F.X_EJC] + J * xo[F.X_JJ]) * r
        Cn = (E * xo[F.X_ECC] + C * xo[F.X_CC]) * r
        B = Nn * xo[F.X_NB] + En * xo[F.X_EB] + Jn * xo[F.X_JB]
        N, E, J, C = Nn, En, Jn, Cn
        _, ex = np.frexp(N + B + E + J + C)  # total = m 2^e, m in [0.5, 1)
        r = f32(np.ldexp(1.0, -int(ex)))
        esum += int(ex)
        rows.append((M, I, (N, J, C), r))
    Q = (E * xo[F.X_ET] + C * xo[F.X_CT]) * r
    fwd = math.log(Q) + esum * math.log(2.0) if Q > 0 else F._NEG
    if not post:
        return fwd
    # Backward on the Forward's scales: bD = alpha + beta bE
    beta_n = _next(_scan_down(dv, tddn))
    bM = np.zeros(Kpad, f32)
    bI, gM = bM.copy(), bM.copy()
    bN = bJ = bC = gI = gX = f32(0)
    for p in range(len(seq) - 1, -1, -1):
        last = p == len(seq) - 1
        rn = f32(1) if last else rows[p + 1][3]
        mb = (np.zeros(Kpad, f32) if last
              else odds(em[seq[p + 1]]) * bM * rn)
        bB = (tbm * mb).sum(dtype=f32)
        end = f32(last)
        bE = (end * xo[F.X_ET] + xo[F.X_EB] * bB
              + (xo[F.X_EJC] * bJ + xo[F.X_ECC] * bC) * rn)
        bN, bJ, bC = (xo[F.X_NB] * bB + xo[F.X_NN] * bN * rn,
                      xo[F.X_JB] * bB + xo[F.X_JJ] * bJ * rn,
                      end * xo[F.X_CT] + xo[F.X_CC] * bC * rn)
        nx = _next(mb)
        alpha_n = _next(_scan_down(tdm * nx, tddn))
        bi = bI * rn
        bM = bE + tmm * nx + tmi * bi + tmdn * (alpha_n + beta_n * bE)
        bI = tim * nx + tii * bi
        Mf, If, (Nf, Jf, Cf), rp = rows[p]
        cl = rp / Q
        gM = gM + Mf * bM * cl
        gI = gI + (If * bI).sum(dtype=f32) * cl
        gX = gX + (Nf * bN + Jf * bJ + Cf * bC) * cl
    return np.concatenate([[fwd, gI, gX], gM])


def model_rows(scorer, seq):
    a = scorer.launch_args(0, seq)
    args = (a["em"][0].numpy(), a["tv"][0].numpy(), a["res"].tolist(),
            a["xv"][0].numpy())
    return a, scaled_odds(*args, post=False), scaled_odds(*args, post=True)


def assert_rows_close(got, want):
    """(fwd, gI, gNCJ, gM...) rows: the Forward in bits, usages absolute."""
    got = np.asarray(got, np.float64).copy()
    want = np.asarray(want, np.float64).copy()
    got[0] /= F.LN2
    want[0] /= F.LN2
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL)


def peaked_string(hmm, L, seed):
    """The profile's own residues, one in ten an 'X'."""
    rng = np.random.default_rng(seed)
    best = hmm.match_lprobs.argmax(1)
    return "".join(AMINO[best[j % hmm.length]] if rng.random() > 0.1
                   else "X" for j in range(L))


def model_case(name):
    """(HMMProfile, amino string): sample_hmm profiles with a random
    string (a share of 'X'), or a peaked profile with its own residues,
    whose Forward (307 nats at L 150) would overflow f32 odds unscaled
    after some 45 positions."""
    rng = np.random.default_rng(len(name))
    if name == "peaked":
        hmm = peaked_hmm(60, 130)
        return hmm, peaked_string(hmm, 150, 1)
    K, L = {"L1": (12, 1), "L3000": (40, 3000), "Kpad16": (16, 20),
            "Kpad16384": (9000, 6)}[name]
    return sample_hmm(K + 7, K)[0], amino_string(rng, L, 0.05)


@pytest.mark.parametrize("name", ["L1", "L3000", "Kpad16", "Kpad16384",
                                  "peaked"])
def test_scaled_odds_model_matches_reference(name):
    hmm, seq = model_case(name)
    assert "X" in seq or len(seq) < 5
    port = p_forward.AminoForwardScorer([hmm], device="cpu")
    ref = r_forward.AminoForwardScorer([to_ref(hmm)])
    args, fwd, row = model_rows(port, seq)
    assert fwd == row[0]
    # _jit_posterior
    rf, rgM, rgI, rgN = ref.posterior_usages(0, seq)
    assert_rows_close(row, np.concatenate([[rf, rgI, rgN], rgM]))
    # _jit_forward, as the reference's bit score
    assert port.score_bits(len(seq), fwd, 0.0) == pytest.approx(
        ref.bit_score(0, seq, null2=False), rel=RTOL, abs=ATOL)
    # the plain versions
    assert_rows_close(row, p_forward.amino_posterior_plain(**args)[0])
    # every residue is emitted by exactly one emitting state
    assert row[1:].sum() == pytest.approx(len(seq), rel=1e-5)


def test_scaled_odds_model_exact_on_a_long_peaked_hit():
    """A peaked hit of 700 residues (1534 nats): the model within the
    tolerance of the plain versions evaluated in f64, and nearer to them
    than the plain versions in f32 (whose log-space rounding strays past
    the tolerance there)."""
    hmm = peaked_hmm(60, 130)
    seq = peaked_string(hmm, 700, 1)
    port = p_forward.AminoForwardScorer([hmm], device="cpu")
    args, fwd, row = model_rows(port, seq)
    exact = p_forward.amino_posterior_plain(**{
        k: v.double() if v.is_floating_point() else v
        for k, v in args.items()})[0].numpy()
    assert exact[0] > 1000
    assert_rows_close(row, exact)
    f32_row = p_forward.amino_posterior_plain(**args)[0].numpy()
    assert np.abs(row - exact).max() < np.abs(f32_row - exact).max() / 10


def test_plain_versions_in_f64_match_f32_on_a_short_hit():
    """exact_confirmer's scorer evaluates the same plain versions in f64:
    on a short hit its usages and score are the f32 ones within the
    tolerance."""
    hmm = peaked_hmm(61, 40)
    seq = peaked_string(hmm, 30, 2)
    a = p_forward.AminoForwardScorer([hmm], device="cpu")
    b = exact_confirmer([hmm]).scorer
    ua, ub = a.posterior_usages(0, seq), b.posterior_usages(0, seq)
    assert ua[1].dtype == np.float32 and ub[1].dtype == np.float64
    assert_rows_close(np.concatenate([[ua[0], ua[2], ua[3]], ua[1]]),
                      np.concatenate([[ub[0], ub[2], ub[3]], ub[1]]))
    assert a.bit_score(0, seq, True) == pytest.approx(
        b.bit_score(0, seq, True), rel=RTOL, abs=ATOL)
    with pytest.raises(TypeError):  # the wrappers take f32 only
        p_forward.amino_forward(**{
            k: v.double() if v.is_floating_point() else v
            for k, v in a.launch_args(0, seq).items()})


class ModelScorer(p_forward.AminoForwardScorer):
    """AminoForwardScorer whose launches run the kernels' arithmetic:
    each hit's row from `scaled_odds`."""

    def _launch_groups(self, hits, fn, posterior=False):
        rows = []
        for p, q in hits:
            a = self.launch_args(p, q)
            rows.append(np.asarray(scaled_odds(
                a["em"][0].numpy(), a["tv"][0].numpy(), a["res"].tolist(),
                a["xv"][0].numpy(), post=posterior)))
        return rows


def near_cutoff_hit(name):
    """(HMMProfile, amino string): "L700", 700 residues against
    peaked_hmm(60, 130), one in two the profile's own and the rest
    random; "L1500", 1500 against peaked_hmm(63, 60), two in five its
    own.  The reference's f32 log-space posterior drifts there: its null2
    bias is 0.82 and 5.19 nats below the f64 value, its bit score 1.19
    and 7.50 bits above it."""
    seed, K, L, rate = {"L700": (60, 130, 700, 0.5),
                        "L1500": (63, 60, 1500, 0.6)}[name]
    hmm = peaked_hmm(seed, K)
    rng = np.random.default_rng(5)
    best = hmm.match_lprobs.argmax(1)
    return hmm, "".join(AMINO[best[j % K]] if rng.random() > rate
                        else AMINO[rng.integers(0, 20)] for j in range(L))


@pytest.mark.parametrize("name", ["L700", "L1500"])
@pytest.mark.parametrize("policy", ["ga", "evalue"])
def test_decision_near_the_cutoff_follows_the_exact_score(policy, name):
    """A hit whose score lies within the reference's drift of the cutoff
    (the GA line, or the E-value cutoff with Z) decides as the exact score
    does.  The kernels' arithmetic (ModelScorer) scores it within 1e-2
    bits of the plain versions in f64; the reference more than a bit
    above.  With the cutoff half way between, the expected decision is
    the exact one: the port drops the hit, where the reference keeps it
    (a known difference of the port's e-values from the reference's,
    PERF.md section 2)."""
    hmm, seq = near_cutoff_hit(name)
    exact = exact_confirmer([hmm]).scorer.bit_score(0, seq, True)
    model = ModelScorer([hmm], device="cpu").bit_score(0, seq, True)
    ref = r_forward.AminoForwardScorer([to_ref(hmm)])
    r_score = ref.bit_score(0, seq, null2=True)
    assert abs(model - exact) < 1e-2
    assert r_score - exact > 1.0
    cut = (exact + r_score) / 2
    kw = dict(num_proteins=1000)
    if policy == "ga":
        hmm.ga = (cut, cut)
    else:
        log_e = F.AminoForwardScorer([hmm], device="cpu").log_evalue(
            0, cut, 1000.0)
        kw["evalue_cutoff"] = math.exp(log_e)
    port = p_forward.NativeConfirmer([hmm], device="cpu", **kw)
    port.scorer = ModelScorer([hmm], device="cpu")
    assert port.confirm(0, seq) == (0.0, None)  # dropped
    assert exact_confirmer([hmm], **kw).confirm(0, seq) == (0.0, None)
    r_log_e, r_blob = r_forward.NativeConfirmer([to_ref(hmm)],
                                                **kw).confirm(0, seq)
    assert r_log_e < 0 and r_blob is not None  # kept


# ---------------------------------------------------------------------------
# the batched route
# ---------------------------------------------------------------------------


def test_kpad_groups_keep_order():
    assert p_forward.kpad_groups([]) == []
    assert p_forward.kpad_groups([64, 16, 64, 2048, 16, 64]) == [
        (64, [0, 2, 5]), (16, [1, 4]), (2048, [3])]


def test_budget_chunks_keep_order_within_the_budget():
    per = p_forward.posterior_scratch_bytes(1, 128)
    assert per == 8 * 128 + 16
    chunk = p_forward.budget_chunks
    assert chunk([], [], 128, per) == []
    ids, lens = [0, 2, 3, 4], [50, 80, 70, 60]
    assert chunk(ids, lens, 128, 10 ** 12) == [ids]
    assert chunk(ids, lens, 128, 130 * per) == [[0, 2], [3, 4]]
    assert chunk(ids, lens, 128, 150 * per) == [[0, 2], [3, 4]]
    assert chunk(ids, lens, 128, 129 * per) == [[0], [2], [3], [4]]
    assert chunk(ids, lens, 128, 10 * per) == [[0], [2], [3], [4]]


def test_posterior_scratch_budget_splits_a_kpad_group(monkeypatch):
    """A posterior Kpad group past POSTERIOR_SCRATCH_BYTES takes one
    launch a budget chunk (`launch_plan`), in order, with the rows of the
    group in one launch; the Forward is never split."""
    hmms = [peaked_hmm(500 + i, k) for i, k in enumerate((100, 30, 120, 90))]
    rng = np.random.default_rng(9)
    hits = [(p, amino_string(rng, n)) for p, n in
            ((0, 50), (1, 20), (2, 80), (3, 70), (0, 60))]
    sc = p_forward.AminoForwardScorer(hmms, device="cpu")
    launches = []
    plain = p_forward.amino_posterior

    def counted(**a):
        launches.append(a["off"].shape[0] - 1)
        return plain(**a)

    monkeypatch.setattr(p_forward, "amino_posterior", counted)
    whole = sc.posterior_usages_many(hits)
    assert launches == [4, 1]  # Kpad 128, then 32
    monkeypatch.setattr(p_forward, "POSTERIOR_SCRATCH_BYTES",
                        p_forward.posterior_scratch_bytes(130, 128))
    assert sc.launch_plan(hits, posterior=True) == [[0, 2], [3, 4], [1]]
    assert sc.launch_plan(hits) == [[0, 2, 3, 4], [1]]
    launches.clear()
    split = sc.posterior_usages_many(hits)
    assert launches == [2, 2, 1]
    for a, b in zip(whole, split):
        assert (a[0], a[2], a[3]) == (b[0], b[2], b[3])
        assert np.array_equal(a[1], b[1])


def test_confirm_many_mixed_wave_matches_hit_by_hit_and_reference():
    """One confirm_many call over hits of three Kpad groups, an empty
    string, GA and Z profiles, kept and dropped: the per-hit answers, in
    order, and the reference's decisions and log-E."""
    hmms = [peaked_hmm(80 + i, k) for i, k in enumerate((20, 100, 30, 300))]
    hmms[2].ga = (-1000.0, -1000.0)  # GA, always reached
    hmms[3].ga = (1000.0, 1000.0)  # GA, never
    rng = np.random.default_rng(8)
    own = ["".join(AMINO[i] for i in h.match_lprobs.argmax(1)) for h in hmms]
    hits = [(0, own[0]), (1, amino_string(rng, 50)), (2, own[2][:9]),
            (1, ""), (3, own[3][:40]), (0, amino_string(rng, 12)),
            (1, own[1])]
    assert len({p_forward._pad_pow2(hmms[p].length) for p, _ in hits}) == 3
    conf = p_forward.NativeConfirmer(hmms, num_proteins=400, device="cpu")
    got = conf.confirm_many(hits)
    assert got == [conf.confirm(p, q) for p, q in hits]
    ref = r_forward.NativeConfirmer([to_ref(h) for h in hmms],
                                    num_proteins=400)
    kept = []
    for (p, q), (lg, blob) in zip(hits, got):
        rl, rblob = ref.confirm(p, q)
        assert (blob is None) == (rblob is None)
        assert lg == pytest.approx(rl, rel=RTOL, abs=ATOL)
        if blob is not None:
            assert_blobs_close(blob, rblob)
            kept.append(p)
    assert kept == [0, 2, 1]  # Z kept, GA reached, Z kept; GA 1000 drops


class Forwarding:
    """A confirmer without confirm_many: the hit-by-hit route."""

    def __init__(self, confirm):
        self.confirm, self.hits = confirm, 0

    def __call__(self, p_idx, amino_seq):
        self.hits += 1
        return self.confirm(p_idx, amino_seq)


@pytest.mark.parametrize("variant", ["confirm_case", "ga_and_limit"])
def test_batched_route_matches_hit_by_hit_and_reference(
        case, tmp_path, monkeypatch, variant):
    """The confirmed scan on both routes writes the same bytes
    (products.tsv and h3r files); every products.tsv column but the
    e-value is the reference's.  "ga_and_limit": GA lines on two profiles
    (one reached, one not) and HMMER_MAX_AMINO lowered to 150 in both
    pipelines, so that one wave's batch holds GA and Z profiles and
    several Kpad groups, and longer hits are written
    unconfirmed (confirm_case has no empty hit: the mixed-wave test above
    holds one)."""
    (hmms, profiles, seqs), (r_hmms, r_profiles, r_seqs) = case
    limit = 150 if variant == "ga_and_limit" else 100000
    monkeypatch.setattr(p_pipeline, "HMMER_MAX_AMINO", limit)
    monkeypatch.setattr(r_pipeline, "HMMER_MAX_AMINO", limit)
    if variant == "ga_and_limit":
        for hs in (hmms, r_hmms):
            monkeypatch.setattr(hs[2], "ga", (-1000.0, -1000.0))
            monkeypatch.setattr(hs[4], "ga", (1000.0, 1000.0))
    conf = p_forward.NativeConfirmer(hmms, device="cpu")
    batched = BatchRecorder(conf.confirm_many)
    assert p_pipeline.confirm_many_of(conf.confirm) == conf.confirm_many
    assert p_pipeline.confirm_many_of(batched) == batched.confirm_many
    single = Forwarding(conf.confirm)
    assert p_pipeline.confirm_many_of(single) is None
    out = {}
    for name, confirmer in (("batched", batched), ("single", single),
                            ("bound", conf.confirm)):
        sc = p_pipeline.Scanner(profiles, p_pipeline.ScanConfig(
            device="cpu"), confirmer=confirmer)
        sc.run(seqs, str(tmp_path / name))
        out[name] = scan_dir(tmp_path / name)
    assert out["batched"] == out["single"] == out["bound"]
    assert single.hits == len(batched.calls) > 0
    assert len(batched.waves) < len(batched.calls)  # hits a call
    assert all(len(q) + 1 <= limit for _, q, _ in batched.calls)
    if variant == "ga_and_limit":
        wave = max(batched.waves, key=len)
        assert {p for p, _ in wave} >= {1, 2, 4}  # Z, GA, GA
        assert len({p_forward._pad_pow2(hmms[p].length)
                    for p, _ in wave}) >= 2
        rows = [ln.split(b"\t") for ln in
                out["batched"]["products.tsv"].splitlines()[1:]]
        assert any(r[10] == b"1" for r in rows)  # past the limit
    r_conf = r_forward.NativeConfirmer(r_hmms)
    r_sc = r_pipeline.Scanner(r_profiles, r_pipeline.ScanConfig(
        engine="jax"), confirmer=r_conf.confirm)
    r_sc.run(r_seqs, str(tmp_path / "ref"))
    want = scan_dir(tmp_path / "ref")
    got = out["batched"]
    assert got.keys() == want.keys()
    assert (lines_but_evalue(got["products.tsv"])
            == lines_but_evalue(want["products.tsv"]))


def test_confirm_many_answering_fewer_hits_stops_the_scan(case, tmp_path):
    """A confirm_many that answers fewer hits than it was handed raises
    before any of the wave's lines is written."""
    (hmms, profiles, seqs), _ = case
    conf = p_forward.NativeConfirmer(hmms, device="cpu")

    class Short:
        def confirm_many(self, hits):
            return conf.confirm_many(hits)[:-1]

        def __call__(self, p_idx, amino_seq):
            raise AssertionError("the batched route called hit by hit")

    sc = p_pipeline.Scanner(profiles, p_pipeline.ScanConfig(device="cpu"),
                            confirmer=Short())
    with pytest.raises(ValueError, match="answered"):
        sc.run(seqs, str(tmp_path / "short"))
