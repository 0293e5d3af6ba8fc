"""Build and load the port's CUDA kernels.

Every `csrc/*.cu` file is compiled by its own `nvcc` for Hopper (sm_90a),
all started together, and the objects are linked into one shared library
with a plain C interface, loaded with ctypes:

    nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -c
         -Xcompiler -fPIC -o <src>.o csrc/<src>.cu          (one per source)
    nvcc -shared -o build/deciphon_tpu_torch/libdtt_<hash>.so *.o

The library name carries a hash of the sources and flags, so an edited
source is rebuilt and a stale library is never loaded.  The build runs on
first use (never at import: hosts without nvcc import every module).
Fast-math and flush-to-zero stay off: the min-plus kernels must keep IEEE
f32 adds bit for bit (see the notes at the head of each .cu file).

Every exported function returns `cudaGetLastError()` after its launch;
`check()` turns a non-zero code into an exception.

`build_native()` compiles the native CPU engine, `native/deciphon_native.cc`
at the repo root, with g++ and the flags of `native/Makefile` into the same
directory (never into `native/`), as `libdeciphon_native_<hash>.so`; the
hash also covers what g++ makes of `-march=native` on this host, so a
library built for another CPU is never loaded.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parent.parent / "build" / "deciphon_tpu_torch"
NVCC_FLAGS = [
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-Xcompiler", "-fPIC",
    # explicit IEEE f32: no flush-to-zero, no contraction
    "-ftz=false", "-prec-div=true", "-prec-sqrt=true", "-fmad=false",
    "-Xptxas", "-v",
]

_P = ctypes.c_void_p
_I = ctypes.c_int
_IP = ctypes.POINTER(ctypes.c_int)
# exported C functions and their argument types (pointers and the stream
# as void*, counts as int)
SIGNATURES = {
    # the score family (B1 and B4, B5 and B4m, B3, B8, B9) and B2 end with
    # the launch shape (c, w, lpt, threads, smem), an int* for the resident
    # clusters and the stream
    "dtt_score_pairs": [_P] * 9 + [_I] * 9 + [_IP, _P],
    "dtt_score_mixed": [_P] * 9 + [_I] * 9 + [_IP, _P],
    "dtt_score_chained": [_P] * 10 + [_I] * 10 + [_IP, _P],
    "dtt_score_chained_carry": [_P] * 15 + [_I] * 10 + [_IP, _P],
    # B6 and B7 end with the launch shape (lpt, threads, smem), an int*
    # for the CTAs an SM holds at once and the stream
    "dtt_score_packed": [_P] * 9 + [_I] * 8 + [_IP, _P],
    "dtt_score_packed_chained": [_P] * 13 + [_I] * 10 + [_IP, _P],
    "dtt_path_pairs": [_P] * 9 + [_I] * 10 + [_IP, _P],
    "dtt_score_grid": [_P] * 8 + [_I] * 9 + [_IP, _P],
    "dtt_walk": [_P, _P, _P, _P, _P, _P, _P, _P,
                 _I, _I, _I, _I, _P],
    # the amino Forward and posterior: inputs, the staged-odds scratch (null
    # up to Kpad 4096), outputs (and the posterior's scratch), the hit count
    # and Kpad, the stream
    "dtt_amino_forward": [_P] * 7 + [_I, _I, _P],
    "dtt_amino_posterior": [_P] * 10 + [_I, _I, _P],
}

_lock = threading.Lock()
_lib: ctypes.CDLL | None = None
build_log: str = ""  # ptxas report of the library (kept beside it)


def find_nvcc() -> str:
    """nvcc from CUDA_HOME, then PATH, then PyTorch's own CUDA_HOME guess."""
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH")
    if home and (Path(home) / "bin" / "nvcc").is_file():
        return str(Path(home) / "bin" / "nvcc")
    found = shutil.which("nvcc")
    if found:
        return found
    from torch.utils.cpp_extension import CUDA_HOME

    if CUDA_HOME and (Path(CUDA_HOME) / "bin" / "nvcc").is_file():
        return str(Path(CUDA_HOME) / "bin" / "nvcc")
    raise RuntimeError(
        "nvcc not found: set CUDA_HOME or put nvcc on PATH to build the "
        "deciphon_tpu_torch kernels")


def sources() -> list[Path]:
    return sorted(CSRC.glob("*.cu"))


def _digest(nvcc: str) -> str:
    h = hashlib.sha256()
    for p in sorted(CSRC.glob("*.cu*")):
        h.update(p.name.encode())
        h.update(p.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    h.update(nvcc.encode())
    return h.hexdigest()[:16]


def build() -> Path:
    """Compile the kernels unless the library for these sources exists."""
    global build_log
    nvcc = find_nvcc()
    out = BUILD_DIR / f"libdtt_{_digest(nvcc)}.so"
    report = out.with_suffix(".log")
    if out.is_file():
        if report.is_file():
            build_log = report.read_text()
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tag = f"{out.stem}.{os.getpid()}"
    objs = [BUILD_DIR / f"{src.stem}.{tag}.o" for src in sources()]
    logs = [o.with_suffix(".log") for o in objs]
    # one nvcc per source, all running at once
    procs = []
    for src, obj, log in zip(sources(), objs, logs):
        with open(log, "w") as fp:
            procs.append(subprocess.Popen(
                [nvcc, *NVCC_FLAGS, "-c", "-o", str(obj), str(src)],
                stdout=fp, stderr=subprocess.STDOUT))
    codes = [p.wait() for p in procs]
    build_log = "".join(log.read_text() for log in logs)
    for log in logs:
        log.unlink()
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    if not any(codes):
        res = subprocess.run([nvcc, "-shared", "-o", str(tmp), *map(str, objs)],
                             capture_output=True, text=True)
        build_log += res.stdout + res.stderr
        codes.append(res.returncode)
    for obj in objs:
        obj.unlink(missing_ok=True)
    if any(codes):
        raise RuntimeError(f"nvcc failed ({codes}):\n{build_log}")
    report.write_text(build_log)
    os.replace(tmp, out)
    return out


NATIVE_SRC = Path(__file__).resolve().parent.parent / "native" / "deciphon_native.cc"
# native/Makefile's CXXFLAGS and LDFLAGS
NATIVE_FLAGS = ["-O3", "-march=native", "-Wall", "-Wextra", "-fPIC",
                "-std=c++17", "-shared", "-pthread"]


def build_native() -> Path:
    """Compile the native CPU engine unless the library for this source,
    these flags and this host's CPU exists; raises when g++ is missing or
    fails."""
    gxx = shutil.which("g++")
    if gxx is None:
        raise RuntimeError("g++ not found: it builds the native CPU engine "
                           f"({NATIVE_SRC.name})")
    # the compiler's version and the target options -march=native resolves
    # to on this host
    probe = [subprocess.run(cmd, capture_output=True, text=True,
                            check=True).stdout
             for cmd in ([gxx, "--version"],
                         [gxx, "-march=native", "-Q", "--help=target"])]
    h = hashlib.sha256(NATIVE_SRC.read_bytes())
    for part in (" ".join(NATIVE_FLAGS), gxx, *probe):
        h.update(part.encode())
    out = BUILD_DIR / f"libdeciphon_native_{h.hexdigest()[:16]}.so"
    if out.is_file():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    res = subprocess.run([gxx, *NATIVE_FLAGS, "-o", str(tmp), str(NATIVE_SRC)],
                         capture_output=True, text=True)
    if res.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f"g++ failed ({res.returncode}):\n{res.stderr}")
    os.replace(tmp, out)
    return out


def lib() -> ctypes.CDLL:
    """The loaded kernel library (built on first call)."""
    global _lib
    with _lock:
        if _lib is None:
            handle = ctypes.CDLL(str(build()))
            for name, argtypes in SIGNATURES.items():
                fn = getattr(handle, name)
                fn.argtypes = argtypes
                fn.restype = ctypes.c_int
            handle.dtt_error_string.argtypes = [ctypes.c_int]
            handle.dtt_error_string.restype = ctypes.c_char_p
            _lib = handle
    return _lib


def check(err: int, what: str) -> None:
    """Raise on a non-zero cudaError_t returned by an exported function."""
    if err != 0:
        msg = lib().dtt_error_string(err).decode()
        raise RuntimeError(f"{what}: CUDA error {err} ({msg})")
