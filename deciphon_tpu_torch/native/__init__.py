"""ctypes bindings for the native CPU engine (native/deciphon_native.cc).

Counterpart of deciphon_tpu/native/__init__.py: the striped AVX2 CPU
Viterbi (the measured baseline and a host engine), fletcher16, fast
sequence encoding and fragment-code precompute.  The library is compiled
by `_build.build_native()` on first use, into the port's build directory;
without g++ that raises, and nothing falls back.
"""

from __future__ import annotations

import ctypes
import os
import threading
import time
from concurrent.futures import ThreadPoolExecutor

import numpy as np

from .. import _build
from ..scan.scheduler import TorchPairScorer


class NativeUnavailable(RuntimeError):
    pass


_lock = threading.Lock()
_lib: ctypes.CDLL | None = None


def load() -> ctypes.CDLL:
    """The loaded native library (built on first call)."""
    global _lib
    with _lock:
        if _lib is None:
            try:
                path = _build.build_native()
            except (RuntimeError, OSError) as exc:
                raise NativeUnavailable(
                    f"cannot build native library: {exc}") from exc
            lib = ctypes.CDLL(str(path))
            lib.dcpn_profile_new.restype = ctypes.c_void_p
            lib.dcpn_profile_new.argtypes = [
                ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p,
                ctypes.c_void_p, ctypes.c_void_p]
            lib.dcpn_profile_del.argtypes = [ctypes.c_void_p]
            lib.dcpn_viterbi.restype = ctypes.c_float
            lib.dcpn_viterbi.argtypes = [ctypes.c_void_p, ctypes.c_void_p,
                                         ctypes.c_int, ctypes.c_void_p]
            lib.dcpn_viterbi_null.restype = ctypes.c_float
            lib.dcpn_viterbi_null.argtypes = [ctypes.c_void_p,
                                              ctypes.c_void_p, ctypes.c_int,
                                              ctypes.c_float]
            lib.dcpn_bench.restype = ctypes.c_double
            lib.dcpn_bench.argtypes = [ctypes.c_void_p, ctypes.c_void_p,
                                       ctypes.c_int, ctypes.c_void_p,
                                       ctypes.c_int, ctypes.c_int]
            lib.dcpn_fletcher16.restype = ctypes.c_uint16
            lib.dcpn_fletcher16.argtypes = [ctypes.c_void_p, ctypes.c_size_t]
            lib.dcpn_encode.restype = ctypes.c_int
            lib.dcpn_encode.argtypes = [ctypes.c_char_p, ctypes.c_int64,
                                        ctypes.c_void_p, ctypes.c_void_p]
            lib.dcpn_frag_codes.argtypes = [ctypes.c_void_p, ctypes.c_int64,
                                            ctypes.c_void_p]
            _lib = lib
    return _lib


def _ptr(a: np.ndarray):
    return a.ctypes.data_as(ctypes.c_void_p)


class NativeProfile:
    """A profile loaded into the native striped kernel."""

    def __init__(self, costs):
        """costs: ops.costs.ViterbiCosts."""
        lib = load()
        self._lib = lib
        # the library copies the tables into its striped layout
        arrays = [np.ascontiguousarray(a, np.float32) for a in (
            costs.core, costs.match, costs.null, costs.background)]
        self.K = costs.K
        self._h = lib.dcpn_profile_new(costs.K, *map(_ptr, arrays))

    def __del__(self):
        if getattr(self, "_h", None):
            self._lib.dcpn_profile_del(self._h)
            self._h = None

    def viterbi(self, codes: np.ndarray, length: int,
                xt: np.ndarray) -> float:
        codes = np.ascontiguousarray(codes, np.int32)
        xt = np.ascontiguousarray(xt, np.float32)
        _check_window(codes, length, xt)
        return float(self._lib.dcpn_viterbi(self._h, _ptr(codes),
                                            int(length), _ptr(xt)))

    def viterbi_null(self, codes: np.ndarray, length: int,
                     rr: float) -> float:
        codes = np.ascontiguousarray(codes, np.int32)
        _check_window(codes, length)
        return float(self._lib.dcpn_viterbi_null(self._h, _ptr(codes),
                                                 int(length),
                                                 ctypes.c_float(rr)))

    def bench_seconds(self, codes: np.ndarray, length: int, xt: np.ndarray,
                      nwin: int, nthreads: int) -> float:
        codes = np.ascontiguousarray(codes, np.int32)
        xt = np.ascontiguousarray(xt, np.float32)
        _check_window(codes, length, xt)
        return float(self._lib.dcpn_bench(self._h, _ptr(codes), int(length),
                                          _ptr(xt), nwin, nthreads))


def _check_window(codes: np.ndarray, length: int, xt=None) -> None:
    """The kernel reads `length` rows of 5 codes (and 13 xtrans costs)."""
    if codes.ndim != 2 or codes.shape[1] != 5 or codes.shape[0] < length:
        raise ValueError(f"codes of shape {codes.shape} for a window of "
                         f"{length}")
    if xt is not None and xt.shape != (13,):
        raise ValueError(f"xt of shape {xt.shape}, expected (13,)")


def fletcher16(data: bytes) -> int:
    lib = load()
    buf = np.frombuffer(data, np.uint8)
    return int(lib.dcpn_fletcher16(_ptr(buf), len(data)))


def encode(seq: str) -> np.ndarray:
    lib = load()
    raw = seq.encode("ascii")
    out = np.empty(len(raw), np.int8)
    bad = ctypes.c_int64(0)
    rc = lib.dcpn_encode(raw, len(raw), _ptr(out), ctypes.byref(bad))
    if rc != 0:
        raise ValueError(f"invalid symbol {seq[bad.value]!r} at {bad.value}")
    return out


def frag_codes(symbols: np.ndarray) -> np.ndarray:
    lib = load()
    symbols = np.ascontiguousarray(symbols, np.int8)
    out = np.empty((len(symbols), 5), np.int32)
    lib.dcpn_frag_codes(_ptr(symbols), len(symbols), _ptr(out))
    return out


REFERENCE_SERVER_CORES = 8  # baseline normalization target (BASELINE.md)


def cpu_baseline_gcups(core_size: int = 400, length: int = 2048,
                       nwin: int | None = None) -> float:
    """Measured multithreaded striped-kernel GCUPS, normalized to an
    8-core server (the reference's deployment class; the host may have
    fewer cores, so per-core throughput is scaled)."""
    from ..ops.costs import build_costs
    from ..profile import sample_profile
    from ..scan.sequence import frag_codes_ending
    from ..xtrans import xtrans_cost_vector

    ncores = os.cpu_count() or 1
    if nwin is None:
        nwin = max(2 * ncores, 8)
    costs = build_costs(sample_profile(77, core_size))
    prof = NativeProfile(costs)
    rng = np.random.default_rng(0)
    seq = rng.integers(0, 4, size=length).astype(np.int8)
    codes = frag_codes_ending(seq)
    xt = xtrans_cost_vector(True, False, length)
    prof.viterbi(codes, length, xt)  # warm
    dt = prof.bench_seconds(codes, length, xt, nwin, ncores)
    cells = nwin * length * 5 * core_size
    measured = cells / dt / 1e9
    return measured * REFERENCE_SERVER_CORES / ncores


class NativePairScorer(TorchPairScorer):
    """Multithreaded native-CPU pair scorer: the reads/s baseline engine.

    Phase 1 scores every (profile, window) pair of a wave on the striped
    AVX2 kernel, fanned out over OS threads like the reference's OpenMP
    scan loop (c-core/scan.c:188, thread.c:49-86): ctypes releases the GIL
    for each kernel call, so the fan-out is real.  Phase 2 is the torch
    engine's (`TorchPairScorer.paths_dispatch`: viterbi_path_batch and the
    walk kernel) on `device`.  `native_score` is the fan-out wall and
    `native_kernel_threads` the sum of in-kernel thread seconds (their
    ratio over nthreads is the thread utilization).
    """

    def __init__(self, costs_list, device: str = "cuda",
                 nthreads: int | None = None):
        super().__init__(costs_list, device)
        from ..xtrans import XT_RR

        self.profiles = [NativeProfile(c) for c in costs_list]
        self.nthreads = nthreads or os.cpu_count() or 1
        self._xt_rr = XT_RR
        self._kernel_lock = threading.Lock()
        self._kernel_s = 0.0

    def _score_one(self, it):
        t0 = time.perf_counter()
        prof = self.profiles[it.p_idx]
        codes, xt, L = it.codes, it.xt, it.win.length
        alt = prof.viterbi(codes, L, xt)
        nul = prof.viterbi_null(codes, L, float(xt[self._xt_rr]))
        dt = time.perf_counter() - t0
        with self._kernel_lock:
            self._kernel_s += dt
        return id(it), (nul, alt)

    def score(self, items) -> dict:
        """Returns {id(item) -> (null_cost, alt_cost)}."""
        t0 = time.perf_counter()
        k0 = self._kernel_s
        if len(items) == 1:
            out = dict([self._score_one(items[0])])
        else:
            with ThreadPoolExecutor(max_workers=self.nthreads) as pool:
                out = dict(pool.map(self._score_one, items))
        if self.metrics is not None:
            self.metrics.add_wall("native_score", time.perf_counter() - t0)
            self.metrics.add_wall("native_kernel_threads",
                                  self._kernel_s - k0)
        return out

