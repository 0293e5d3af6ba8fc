"""The port's native CPU engine (deciphon_tpu_torch/native): the striped
C++ Viterbi against the port's plain `viterbi_torch` (rtol 1e-6, atol
1e-5, the tolerance of tests/test_native.py), encode / frag_codes /
fletcher16 equal to the reference package's, its build keyed by source,
flags and host CPU, and `Scanner(engine="native", device="cpu")` writing
the reference's `engine="native"` products byte for byte.
"""

from pathlib import Path

import numpy as np
import pytest
import torch

import deciphon_tpu.native as r_native
import deciphon_tpu.profile as r_profile
import deciphon_tpu.scan.pipeline as r_pipeline
import deciphon_tpu.scan.sequence as r_sequence
from deciphon_tpu_torch import _build
from deciphon_tpu_torch import native as p_native
from deciphon_tpu_torch.ops import viterbi_torch as vt
from deciphon_tpu_torch.ops.costs import build_costs
from deciphon_tpu_torch.profile import sample_profile
from deciphon_tpu_torch.scan import pipeline as p_pipeline
from deciphon_tpu_torch.scan.sequence import frag_codes_ending
from deciphon_tpu_torch.workload import confirm_case
from deciphon_tpu_torch.xtrans import XT_RR, xtrans_cost_vector

torch.set_num_threads(1)


@pytest.mark.parametrize("seed,K,L,mh,h3c", [
    (1, 5, 37, True, False),
    (2, 23, 64, False, False),
    (3, 40, 120, True, True),
    (4, 130, 300, False, True),
])
def test_native_viterbi_matches_plain(seed, K, L, mh, h3c):
    costs = build_costs(sample_profile(seed, K), mh, h3c)
    rng = np.random.default_rng(seed)
    seq = rng.integers(0, 4, size=L).astype(np.int8)
    codes = frag_codes_ending(seq)
    xt = xtrans_cost_vector(mh, h3c, L)
    prof = p_native.NativeProfile(costs)
    t = [torch.from_numpy(np.array(a)) for a in (
        costs.core, costs.match, costs.null, costs.background, xt, codes)]
    want = float(vt.viterbi(*t, L))
    np.testing.assert_allclose(prof.viterbi(codes, L, xt), want,
                               rtol=1e-6, atol=1e-5)
    want_n = float(vt.viterbi_null(t[2], xt[XT_RR], t[5], L))
    np.testing.assert_allclose(prof.viterbi_null(codes, L, float(xt[XT_RR])),
                               want_n, rtol=1e-6, atol=1e-5)
    # the same striped kernel as the reference package's library
    r_prof = r_native.NativeProfile(costs)
    assert prof.viterbi(codes, L, xt) == r_prof.viterbi(codes, L, xt)
    with pytest.raises(ValueError, match="window"):
        prof.viterbi(codes[:L - 1], L, xt)


@pytest.mark.parametrize("what", ["encode", "frag_codes", "fletcher16",
                                  "bench", "baseline"])
def test_native_helpers_match_reference(what):
    if what == "encode":
        for s in ("ACGTUACG", "TTTT", "", "acgu"):
            try:
                want = r_native.encode(s)
            except ValueError as exc:
                with pytest.raises(ValueError, match=str(exc)[:16]):
                    p_native.encode(s)
                continue
            got = p_native.encode(s)
            assert got.dtype == want.dtype and np.array_equal(got, want)
        with pytest.raises(ValueError, match="'N'"):
            p_native.encode("ACGN")
    elif what == "frag_codes":
        rng = np.random.default_rng(3)
        for n in (1, 2, 5, 257):
            sym = rng.integers(0, 4, size=n).astype(np.int8)
            got = p_native.frag_codes(sym)
            assert np.array_equal(got, r_native.frag_codes(sym))
            assert np.array_equal(got, frag_codes_ending(sym))
    elif what == "fletcher16":
        for data in (b"", b"abcde", bytes(range(256)) * 37):
            assert p_native.fletcher16(data) == r_native.fletcher16(data)
    elif what == "bench":
        costs = build_costs(sample_profile(9, 32))
        prof = p_native.NativeProfile(costs)
        seq = np.random.default_rng(0).integers(0, 4, 256).astype(np.int8)
        dt = prof.bench_seconds(frag_codes_ending(seq), 256,
                                xtrans_cost_vector(True, False, 256),
                                nwin=4, nthreads=2)
        assert dt > 0
    else:
        assert p_native.cpu_baseline_gcups(core_size=40, length=128,
                                           nwin=2) > 0


def test_native_build_key_and_missing_compiler(monkeypatch, tmp_path):
    """The library lands in the port's build directory, not in native/;
    its name follows the source, and g++'s absence raises (no
    fallback)."""
    path = _build.build_native()
    assert path.parent == _build.BUILD_DIR and path.is_file()
    assert path.name.startswith("libdeciphon_native_")
    assert _build.NATIVE_SRC == Path(_build.__file__).resolve().parent.parent \
        / "native" / "deciphon_native.cc"
    assert "-march=native" in _build.NATIVE_FLAGS
    src = tmp_path / "x.cc"
    src.write_text(_build.NATIVE_SRC.read_text() + "\n// edited\n")
    monkeypatch.setattr(_build, "NATIVE_SRC", src)
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path / "build")
    monkeypatch.setattr(_build.shutil, "which", lambda name: None)
    with pytest.raises(RuntimeError, match="g\\+\\+ not found"):
        _build.build_native()


@pytest.fixture(scope="module")
def case():
    """confirm_case's five pressed profiles (K 9 to 200) and four reads
    of 700 nt, in both packages."""
    _, profiles, seqs = confirm_case()
    ref = ([r_profile.FrameProfile(**vars(p)) for p in profiles],
           [r_sequence.Sequence.make(s.id, s.name, s.data) for s in seqs])
    return (profiles, seqs), ref


@pytest.mark.parametrize("threads", [1, 3])
def test_native_engine_matches_reference(case, tmp_path, threads):
    """The native engine drives the port's pipeline (phase 2 on the torch
    engine's path and walk, on the CPU here) to the reference's
    engine="native" products, byte for byte, and to the kernels route's."""
    (profiles, seqs), (r_profiles, r_seqs) = case
    got = p_pipeline.Scanner(profiles, p_pipeline.ScanConfig(
        engine="native", device="cpu", num_threads=threads))
    assert isinstance(got.scorer, p_native.NativePairScorer)
    assert got.scorer.nthreads == threads
    out = got.run(seqs, str(tmp_path / "port"))
    assert got.metrics.walls["native_score"] > 0
    want = r_pipeline.Scanner(r_profiles, r_pipeline.ScanConfig(
        engine="native", num_threads=threads)).run(
        r_seqs, str(tmp_path / "ref"))
    tsv = Path(out).read_bytes()
    assert tsv == Path(want).read_bytes()
    assert tsv.count(b"\n") > 1
    kernels = p_pipeline.Scanner(profiles, p_pipeline.ScanConfig(
        device="cpu")).run(seqs, str(tmp_path / "kernels"))
    assert Path(kernels).read_bytes() == tsv
