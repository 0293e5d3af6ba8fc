"""Confirmation in the port against the reference: the amino Forward and
posterior plain versions against `_jit_forward` / `_jit_posterior`, the
host parts (`_profile_arrays`, bit scores, e-values, null2, the keep
policy), and confirmed scans against the reference's `engine="jax"`
Scanner with the native confirmer and with the hmmpgmd client against the
fake daemon.

Tolerances: Forward scores, bit scores and log-E within rtol 1e-4, atol
1e-3 (the reference's own tolerance against brute force,
tests/test_hmmer.py), usages within the same and summing to L within rtol
1e-4.  Log-add in f32 is not associative, and XLA's associative scan and
reductions run in their own tree order, so the two engines agree within a
tolerance, not bit for bit.  Every input is made from a seed with numpy.
"""

import io
import math
from pathlib import Path

import numpy as np
import pytest
import torch

import deciphon_tpu.hmmer.client as r_client
import deciphon_tpu.hmmer.daemon as r_daemon
import deciphon_tpu.hmmer.forward as r_forward
import deciphon_tpu.hmmer.h3result as r_h3
import deciphon_tpu.hmmfile as r_hmmfile
import deciphon_tpu.profile as r_profile
from deciphon_tpu.scan import pipeline as r_pipeline
from deciphon_tpu.scan.sequence import Sequence as r_Sequence
import deciphon_tpu_torch.hmmer.client as p_client
import deciphon_tpu_torch.hmmer.daemon as p_daemon
import deciphon_tpu_torch.hmmer.forward as p_forward
import deciphon_tpu_torch.hmmer.h3result as p_h3
import deciphon_tpu_torch.hmmfile as p_hmmfile
from deciphon_tpu_torch.convert import (frame_profile_from_arrays,
                                        hmm_profile_from_arrays)
from deciphon_tpu_torch.profile import press_profile
from deciphon_tpu_torch.scan import pipeline as p_pipeline
from deciphon_tpu_torch.workload import (SAMPLE_FORWARD_STATS,
                                         confirm_case, peaked_hmm,
                                         sample_hmm)
from test_torch_copies import HMM_TEXT, same_fields

# One torch thread: the plain versions run thousands of small ops, and
# several test workers with a thread pool each starve one another.
torch.set_num_threads(1)

RTOL, ATOL = 1e-4, 1e-3
AMINO = "ACDEFGHIKLMNPQRSTVWY"


def to_ref(hmm):
    """The reference's HMMProfile with the port's fields."""
    return r_hmmfile.HMMProfile(**vars(hmm))


def random_hmm(seed, K):
    """tests/test_hmmer.py's tiny_hmm: every transition row drawn whole."""
    rng = np.random.default_rng(seed)

    def lprobs(n):
        p = rng.random(n)
        return np.log(p / p.sum())

    match = np.stack([lprobs(20) for _ in range(K)])
    trans = np.stack([lprobs(7) for _ in range(K + 1)])
    return p_hmmfile.HMMProfile(
        name=f"t{seed}", accession=f"T{seed}", length=K, consensus="-" * K,
        match_lprobs=match.astype(np.float32),
        trans=trans.astype(np.float32), stats={"FORWARD": (-5.0, 0.7)})


def amino_string(rng, n, degenerate=0.1):
    return "".join("X" if rng.random() < degenerate
                   else AMINO[int(rng.integers(0, 20))] for _ in range(n))


# (K, L): Kpad 16, 16, 64, 256 and Lpad 16, 16, 32, 512: few distinct
# shapes, each a JAX compile
SHAPES = [(2, 1), (3, 4), (37, 17), (130, 300)]


@pytest.fixture(scope="module")
def scorers():
    """{(K, L): (reference scorer, port scorer on the CPU, amino string)},
    'X' residues among them; K = 130 is a peaked profile (its string
    scores far above the null), the rest draw every transition row."""
    out = {}
    for i, (K, L) in enumerate(SHAPES):
        hmm = peaked_hmm(60 + i, K) if K == 130 else random_hmm(60 + i, K)
        rng = np.random.default_rng(K * 1000 + L)
        if K == 130:  # the profile's own residues, with some noise
            best = hmm.match_lprobs.argmax(1)
            seq = "".join(AMINO[best[j % K]] if rng.random() > 0.1
                          else amino_string(rng, 1, 0.5) for j in range(L))
        else:
            seq = amino_string(rng, L)
        assert "X" in seq or L < 5
        out[(K, L)] = (r_forward.AminoForwardScorer([to_ref(hmm)]),
                       p_forward.AminoForwardScorer([hmm], device="cpu"),
                       seq)
    return out


@pytest.mark.parametrize("K,L", SHAPES)
def test_plain_forward_matches_jit_forward(scorers, K, L):
    ref, port, seq = scorers[(K, L)]
    want = ref.bit_score(0, seq, null2=False)
    got = port.bit_score(0, seq, null2=False)
    assert got == pytest.approx(want, rel=RTOL, abs=ATOL)
    assert math.isfinite(got)
    # the plain version itself, against the reference's Forward in nats
    fwd = float(p_forward.amino_forward(**port.launch_args(0, seq))[0])
    rfwd = ref.posterior_usages(0, seq)[0]
    assert fwd / p_forward.LN2 == pytest.approx(rfwd / r_forward.LN2,
                                                rel=RTOL, abs=ATOL)


@pytest.mark.parametrize("K,L", SHAPES)
def test_plain_posterior_matches_jit_posterior(scorers, K, L):
    ref, port, seq = scorers[(K, L)]
    rf, rgM, rgI, rgN = ref.posterior_usages(0, seq)
    pf, pgM, pgI, pgN = port.posterior_usages(0, seq)
    assert pf / p_forward.LN2 == pytest.approx(rf / r_forward.LN2, rel=RTOL,
                                               abs=ATOL)
    assert pgM.shape == rgM.shape == (p_forward._pad_pow2(K),)
    np.testing.assert_allclose(pgM, rgM, rtol=RTOL, atol=ATOL)
    assert pgI == pytest.approx(rgI, rel=RTOL, abs=ATOL)
    assert pgN == pytest.approx(rgN, rel=RTOL, abs=ATOL)
    # every residue is emitted by exactly one emitting state: the totals
    # are L within rtol 1e-4 where the Forward is tens of nats; at K = 130
    # (607 nats) the f32 terms exp(Mf + bM - fwd) carry fwd's rounding and
    # the reference's own total is 299.9637, which the port's matches
    total = pgM.sum() + pgI + pgN
    np.testing.assert_allclose(total, rgM.sum() + rgI + rgN, rtol=1e-6)
    if abs(rf) < 100:
        np.testing.assert_allclose(total, L, rtol=RTOL)
    # the posterior's Forward is the Forward's
    assert pf == pytest.approx(float(p_forward.amino_forward(
        **port.launch_args(0, seq))[0]), rel=1e-6, abs=1e-5)


@pytest.mark.parametrize("K,L", SHAPES)
def test_bit_score_evalue_and_null2_match_reference(scorers, K, L):
    ref, port, seq = scorers[(K, L)]
    assert port.null2_bias_nats(0, seq) == pytest.approx(
        ref.null2_bias_nats(0, seq), rel=RTOL, abs=ATOL)
    for Z in (1.0, 200.0):
        got, want = port.evalue(0, seq, Z, True), ref.evalue(0, seq, Z, True)
        assert got == pytest.approx(want, rel=RTOL, abs=ATOL)
    assert port.bit_score(0, "") == ref.bit_score(0, "") == -math.inf
    assert port.null2_bias_nats(0, "") == 0.0


@pytest.mark.parametrize("K", [1, 2, 9, 16, 17, 130, 700])
def test_profile_arrays_bit_equal(K):
    hmm = random_hmm(K, K)
    ref = r_forward.AminoForwardScorer([to_ref(hmm)])
    port = p_forward.AminoForwardScorer([hmm], device="cpu")
    Kpad = p_forward._pad_pow2(K)
    got, want = port._profile_arrays(0, Kpad), ref._profile_arrays(0, Kpad)
    assert len(got) == len(want) == 10
    for a, b in zip(got, want):
        assert a.dtype == b.dtype and np.array_equal(a, b)
    # the device table: the emission columns, its degenerate row the
    # reference's patch of its emission plane
    em, tv = port._device_arrays(0, Kpad)
    assert em.shape == (21, Kpad) and tv.shape == (p_forward.NUM_TV, Kpad)
    assert np.array_equal(em[:20].numpy(), want[0][:, :20].T)
    deg = np.zeros(Kpad, np.float32)
    deg[K:] = p_forward._NEG
    assert np.array_equal(em[20].numpy(), deg)
    assert np.array_equal(tv[:p_forward.TV_S].numpy(), np.stack(want[1:]))


@pytest.fixture(scope="module")
def ga_hmms():
    """The inline HMM (with GA) of test_torch_copies in both packages, with
    a FORWARD line."""
    out = []
    for mod in (p_hmmfile, r_hmmfile):
        (h,) = mod.read_hmm(io.StringIO(HMM_TEXT))
        h.stats["FORWARD"] = (-20.0, 0.69315)
        out.append(h)
    return out


@pytest.mark.parametrize("ga,seq", [(None, "KA"), (None, "KAKAKAWW"),
                                    (-60.0, "KA"), (-60.0, "WWWWWWWW")])
def test_native_confirmer_ga_branch(ga_hmms, ga, seq):
    """GA thresholds: Z = 1 and keep when the bit score reaches GA (the
    profile's own 21.0, or one lowered to -60)."""
    ph, rh = ga_hmms
    for h in (ph, rh):
        h.ga = (ga, ga) if ga is not None else (21.0, 20.0)
    got = p_forward.NativeConfirmer([ph], device="cpu").confirm(0, seq)
    want = r_forward.NativeConfirmer([rh]).confirm(0, seq)
    assert got[0] == pytest.approx(want[0], rel=RTOL, abs=ATOL)
    assert (got[1] is None) == (want[1] is None)
    assert (got[1] is None) == (ga is None)  # 21 bits: out of reach
    if got[1] is not None:
        assert_blobs_close(got[1], want[1])
        assert p_h3.H3Result.from_blob(got[1]).stats.Z == 1.0


@pytest.mark.parametrize("kind", ["own", "random", "empty"])
def test_native_confirmer_z_branch(kind):
    """No GA: Z = num_proteins, keep when the e-value passes the cutoff;
    a profile's own residues pass, a random string and an empty one do
    not."""
    hmms = [peaked_hmm(70 + i, k) for i, k in enumerate((30, 64))]
    rng = np.random.default_rng(5)
    seq = {"own": "".join(AMINO[i] for i in hmms[1].match_lprobs.argmax(1)),
           "random": amino_string(rng, 64), "empty": ""}[kind]
    got = p_forward.NativeConfirmer(hmms, num_proteins=500,
                                    device="cpu").confirm(1, seq)
    want = r_forward.NativeConfirmer([to_ref(h) for h in hmms],
                                     num_proteins=500).confirm(1, seq)
    assert got[0] == pytest.approx(want[0], rel=RTOL, abs=ATOL)
    assert (got[1] is None) == (want[1] is None) == (kind != "own")
    if kind == "own":
        assert got[0] < math.log(1e-10)
        assert_blobs_close(got[1], want[1])
        assert p_h3.H3Result.from_blob(got[1]).stats.Z == 500.0


def assert_blobs_close(a: bytes, b: bytes, atol: float = ATOL) -> None:
    """Two h3r blobs: the same decoded fields, floats within rtol 1e-4 and
    `atol`."""
    ha, hb = p_h3.H3Result.from_blob(a), r_h3.H3Result.from_blob(b)
    assert vars(ha.stats) == vars(hb.stats)
    assert len(ha.hits) == len(hb.hits) == 1
    x, y = vars(ha.hits[0]), vars(hb.hits[0])
    assert x.keys() == y.keys()
    for k in x:
        if isinstance(x[k], float):
            assert x[k] == pytest.approx(y[k], rel=RTOL, abs=atol), k
        elif k != "domains":
            assert x[k] == y[k], k


# ---------------------------------------------------------------------------
# confirmed scans
# ---------------------------------------------------------------------------


def both(hmms, profiles, seqs):
    """A scan case in both packages: ((hmms, profiles, sequences) of the
    port, the same of the reference)."""
    ref = ([to_ref(h) for h in hmms],
           [r_profile.press_profile(to_ref(h), 1, 0.1) for h in hmms],
           [r_Sequence.make(s.id, s.name, s.data) for s in seqs])
    for a, b in zip(ref[1], profiles):
        assert same_fields(frame_profile_from_arrays(**vars(a)), b)
    return (hmms, profiles, seqs), ref


@pytest.fixture(scope="module")
def case():
    """confirm_case: five peaked profiles (K 9 to 200), four reads of 700
    nt, hits that the native confirmer keeps and drops."""
    return both(*confirm_case())


class Recorder:
    """A confirmer that records (p_idx, amino string, logevalue) and, with
    a scorer, each call's (Forward nats, null2 bias nats)."""

    def __init__(self, confirm, scorer=None):
        self.confirm, self.calls, self.parts = confirm, [], []
        self._part = None
        if scorer is not None:
            bias = scorer.null2_bias_nats

            def spy(p_idx, amino_seq, usages=None):
                b = bias(p_idx, amino_seq, usages)
                self._part = (usages[0], b)
                return b
            scorer.null2_bias_nats = spy

    def __call__(self, p_idx, amino_seq):
        self._part = None
        out = self.confirm(p_idx, amino_seq)
        self.calls.append((p_idx, amino_seq, out[0]))
        self.parts.append(self._part)
        return out


class BatchRecorder(Recorder):
    """A Recorder offering confirm_many: the pipeline hands it a wave's
    hits at once.  `waves` keeps each call's hits."""

    def __init__(self, confirm_many, scorer=None):
        super().__init__(None, scorer)
        self.many, self.waves = confirm_many, []

    def confirm_many(self, hits):
        out = self.many(hits)
        self.waves.append(list(hits))
        self.calls.extend((p, q, o[0]) for (p, q), o in zip(hits, out))
        return out


def scan_dir(root: Path) -> dict:
    """{relative path: bytes} of a product directory."""
    return {str(p.relative_to(root)): p.read_bytes()
            for p in sorted(root.rglob("*")) if p.is_file()}


def run_both(case, tmp_path, port_confirmer, ref_confirmer, **flags):
    (_, profiles, seqs), (_, r_profiles, r_seqs) = case
    port = p_pipeline.Scanner(profiles, p_pipeline.ScanConfig(
        device="cpu", **flags), confirmer=port_confirmer)
    port.run(seqs, str(tmp_path / "port"))
    ref = r_pipeline.Scanner(r_profiles, r_pipeline.ScanConfig(
        engine="jax", **flags), confirmer=ref_confirmer)
    ref.run(r_seqs, str(tmp_path / "ref"))
    assert port.metrics.survivors == ref.metrics.survivors > 0
    return scan_dir(tmp_path / "port"), scan_dir(tmp_path / "ref")


def lines_but_evalue(tsv: bytes) -> list:
    return [ln.split(b"\t")[:10] + ln.split(b"\t")[11:]
            for ln in tsv.splitlines()]


def test_confirmed_scan_native_matches_reference(case, tmp_path):
    """The native confirmer on both sides: the same hits kept and dropped,
    every products.tsv column but the e-value byte-identical, the same h3r
    files with close fields.  The Forward nats and the null2 bias of each
    hit within rtol 1e-4, atol 1e-3, and log-E within the tolerance they
    carry: log-E = lambda (tau - S) + ln Z with S = (fwd - bias - ...) /
    ln 2, so atol 1e-3 + rtol 1e-4 (|fwd| + |bias|) lambda / ln 2 (hits
    of hundreds of nats cancel: on this case's K = 400 hit the two
    engines' biases of 86.85 nats differ by 8e-5 relative, its log-E of -53
    by 1.3e-4)."""
    (hmms, _, _), (r_hmms, _, _) = case
    p_conf = p_forward.NativeConfirmer(hmms, device="cpu")
    r_conf = r_forward.NativeConfirmer(r_hmms)
    pc = Recorder(p_conf.confirm, p_conf.scorer)
    rc = Recorder(r_conf.confirm, r_conf.scorer)
    got, want = run_both(case, tmp_path, pc, rc)
    assert [c[:2] for c in pc.calls] == [c[:2] for c in rc.calls]
    kept = [c[2] < 0 for c in pc.calls]
    assert kept == [c[2] < 0 for c in rc.calls]
    assert 0 < sum(kept) < len(kept)  # hits kept and hits dropped
    widest = ATOL  # the largest tolerance of a kept hit's score, in bits
    for a, b, pa, pb in zip(pc.calls, rc.calls, pc.parts, rc.parts):
        assert (pa is None) == (pb is None) == (a[1] == "")
        if pa is None:
            assert a[2] == b[2] == 0.0
            continue
        assert pa == pytest.approx(pb, rel=RTOL, abs=ATOL)
        lam = hmms[a[0]].stats["FORWARD"][1]
        bits = ATOL + RTOL * (abs(pb[0]) + abs(pb[1])) / p_forward.LN2
        assert abs(a[2] - b[2]) <= lam * bits, (a[0], len(a[1]), a[2], b[2])
        if a[2] < 0:
            widest = max(widest, bits, lam * bits)
    assert got.keys() == want.keys()
    tsv = "products.tsv"
    assert lines_but_evalue(got[tsv]) == lines_but_evalue(want[tsv])
    assert got[tsv].count(b"\n") == sum(kept) + 1
    h3r = [k for k in got if k.endswith(".h3r")]
    assert len(h3r) == sum(kept)
    for k in h3r:  # bit scores and ln P of the kept hits
        assert_blobs_close(got[k], want[k], widest)


def responder_for(h3mod):
    """A deterministic daemon answer from the query alone: no hit, a hit
    whose e-value clamps to 1, or a kept hit."""
    def respond(hmmidx, seq):
        n = len(seq)
        if n % 3 == 0:
            return h3mod.H3Result(stats=h3mod.H3Stats(Z=6.0, nhits=0),
                                  tophits=h3mod.H3TopHits())
        lnP = -3.0 * (n % 7) - 0.25 * hmmidx
        return h3mod.H3Result.single_hit(
            name=f"p{hmmidx}", acc=f"ACC{hmmidx}", score=2.0 * n, lnP=lnP,
            Z=6.0, qlen=100 + hmmidx, seqlen=n)
    return respond


def test_confirmed_scan_fake_daemon_byte_identical(case, tmp_path):
    """HMMERClient against FakeHMMERDaemon on both sides: products.tsv and
    the h3r files byte-identical."""
    with p_daemon.FakeHMMERDaemon(responder_for(p_h3)) as pd, \
            r_daemon.FakeHMMERDaemon(responder_for(r_h3)) as rd, \
            p_client.HMMERClient("127.0.0.1", pd.port, num_proteins=6,
                                 has_ga=False) as pcl, \
            r_client.HMMERClient("127.0.0.1", rd.port, num_proteins=6,
                                 has_ga=False) as rcl:
        pc, rc = Recorder(pcl.confirm), Recorder(rcl.confirm)
        got, want = run_both(case, tmp_path, pc, rc)
    assert pc.calls == rc.calls
    assert {c[2] < 0 for c in pc.calls} == {True, False}
    assert got == want
    assert any(k.endswith(".h3r") for k in got)


@pytest.mark.parametrize("limit", [60, 150])
def test_hmmer_max_amino_guard(case, tmp_path, monkeypatch, limit):
    """Hits past HMMER_MAX_AMINO (lowered) skip only the confirmation: the
    line is written with e-value 1, in both pipelines alike."""
    assert p_pipeline.HMMER_MAX_AMINO == r_pipeline.HMMER_MAX_AMINO == 100000
    monkeypatch.setattr(p_pipeline, "HMMER_MAX_AMINO", limit)
    monkeypatch.setattr(r_pipeline, "HMMER_MAX_AMINO", limit)

    def reject(p_idx, amino_seq):  # every confirmed hit is dropped
        return 0.0, None

    pc, rc = Recorder(reject), Recorder(reject)
    got, want = run_both(case, tmp_path, pc, rc)
    assert pc.calls == rc.calls and got == want
    assert pc.calls and all(len(c[1]) + 1 <= limit for c in pc.calls)
    rows = [ln.split(b"\t") for ln in got["products.tsv"].splitlines()[1:]]
    assert rows and all(r[10] == b"1" for r in rows)  # unconfirmed: E = 1


@pytest.mark.parametrize("route", ["batched", "hit_by_hit"])
def test_confirmed_scan_resumes_from_checkpoint(case, tmp_path, route):
    """With a confirmer, a scan stopped by should_stop leaves a journal of
    its confirmed lines; a fresh scanner resumes from it to the same
    products and h3r files, confirming fewer hits than a full scan.  On
    both routes: a wave's hits to confirm_many at once, or one call a
    hit."""
    (hmms, profiles, seqs), _ = case
    kw = dict(device="cpu", max_pairs=1, spec_depth=1)

    def scanner():
        native = p_forward.NativeConfirmer(hmms, device="cpu")
        conf = (BatchRecorder(native.confirm_many) if route == "batched"
                else Recorder(native.confirm))
        return p_pipeline.Scanner(profiles, p_pipeline.ScanConfig(**kw),
                                  confirmer=conf), conf

    full_sc, full_conf = scanner()
    full_sc.run(seqs, str(tmp_path / "full"))
    full = scan_dir(tmp_path / "full")
    waves = full_sc.metrics.pairs_batches
    assert waves >= 2 and any(k.endswith(".h3r") for k in full)
    asked = {"n": 0}

    def stop():  # asked before every wave: stop before the last collect
        asked["n"] += 1
        return asked["n"] > waves

    sc, _ = scanner()
    with pytest.raises(p_pipeline.Scanner.Interrupted):
        sc.run(seqs, str(tmp_path / "crash"), checkpoint=True,
               should_stop=stop)
    sc2, conf2 = scanner()
    sc2.run(seqs, str(tmp_path / "crash"), checkpoint=True)
    assert scan_dir(tmp_path / "crash") == full
    assert len(conf2.calls) < len(full_conf.calls)


def test_scanner_signature_matches_reference():
    import inspect

    names = list(inspect.signature(p_pipeline.Scanner).parameters)
    assert names == list(inspect.signature(r_pipeline.Scanner).parameters)
    assert names[:3] == ["profiles", "config", "confirmer"]


@pytest.mark.parametrize("seed,K", [(200, 50), (261, 1406), (5, 9)])
def test_sample_hmm_presses_to_sample_profile(seed, K):
    hmm, null = sample_hmm(seed, K)
    assert hmm.stats == {"FORWARD": SAMPLE_FORWARD_STATS} and not hmm.has_ga
    assert same_fields(press_profile(hmm, 1, 0.1, null_amino_lprobs=null),
                       r_profile.sample_profile(seed, K))


def test_hmm_profile_from_arrays_carries_ga_and_stats():
    (rh,) = r_hmmfile.read_hmm(io.StringIO(HMM_TEXT))
    rh.stats["FORWARD"] = (-3.5, 0.7)
    ph = hmm_profile_from_arrays(**vars(rh))
    assert isinstance(ph, p_hmmfile.HMMProfile)
    assert same_fields(ph, rh) and ph.has_ga and ph.ga == (21.0, 20.0)
    with pytest.raises(ValueError):
        hmm_profile_from_arrays(**dict(vars(rh), trans=rh.trans[:1]))
