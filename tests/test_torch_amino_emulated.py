"""The amino kernels' CUDA source run on the CPU.

csrc/amino_forward.cu is compiled by g++ against a stand-in
cuda_runtime.h that runs one std::thread a CUDA thread: `__syncthreads`
is a barrier of the block's threads, each warp shuffle an exchange
through a per-warp array between two barrier waits of the warp's 32
threads (a shuffle that not every lane reaches deadlocks, so the run is
bounded by a timeout), `__shared__` arrays are shared by the block's
threads, and every float4 access is checked for 16-byte alignment.
Blocks run one after another.  The entry points `dtt_amino_forward` and
`dtt_amino_posterior` are called on host copies of the wrappers'
arguments, so the kernels' own arithmetic and their warp and barrier
logic (the one-barrier position, the cross-warp slots, the threads past
Kpad) are checked here without a card; what only nvcc and the card can
show (registers, timing, the hardware's memory model) is left to
tests/test_torch_cuda.py and chip_smoke.py.

Each output is held to its plain version evaluated in f64 within rtol
1e-4, atol 1e-3 (scores in bits, usages absolute), and a batch's rows
to the same hits launched one at a time, bit for bit.
"""

import re
import shutil
import subprocess

import numpy as np
import pytest
import torch

from deciphon_tpu_torch import _build
from deciphon_tpu_torch.hmmer import forward as hf
from deciphon_tpu_torch.workload import amino_hits

torch.set_num_threads(1)

RUNTIME_H = r'''
#pragma once
#include <barrier>
#include <cmath>
#include <cstdint>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <memory>
#include <thread>
#include <vector>
#include <math.h>
struct dim3 { unsigned x = 1, y = 1, z = 1; };
struct float4 { float x, y, z, w; };
inline float4 make_float4(float a, float b, float c, float d) {
  return {a, b, c, d}; }
typedef int cudaError_t;
typedef void* cudaStream_t;
enum { cudaSuccess = 0, cudaErrorInvalidValue = 1,
       cudaFuncAttributeMaxDynamicSharedMemorySize = 8 };
#define __global__
#define __device__
#define __forceinline__ inline
#define __launch_bounds__(x)
#define __shared__ static
inline thread_local dim3 threadIdx, blockIdx, blockDim;
alignas(16) inline char g_smem[232448];
struct WarpX { std::barrier<> bar{32}; float buf[32]; };
inline thread_local WarpX* t_warp;
inline thread_local std::barrier<>* t_block;
inline thread_local int t_lane;
inline float xch(float v, int src) {
  t_warp->buf[t_lane] = v;
  t_warp->bar.arrive_and_wait();
  float r = t_warp->buf[src];
  t_warp->bar.arrive_and_wait();
  return r;
}
inline float __shfl_up_sync(unsigned, float v, int o) {
  return xch(v, t_lane >= o ? t_lane - o : t_lane); }
inline float __shfl_down_sync(unsigned, float v, int o) {
  return xch(v, t_lane + o < 32 ? t_lane + o : t_lane); }
inline float __shfl_xor_sync(unsigned, float v, int o) {
  return xch(v, t_lane ^ o); }
inline float __shfl_sync(unsigned, float v, int s) { return xch(v, s & 31); }
inline void __syncthreads() { t_block->arrive_and_wait(); }
template <class F> inline int cudaFuncSetAttribute(F, int, int bytes) {
  return bytes > (int)sizeof(g_smem) ? 1 : 0; }
inline int cudaGetLastError() { return 0; }
template <class T, class P> inline T* chk4(P* p) {
  if ((uintptr_t)p % 16) { fprintf(stderr, "misaligned float4\n"); abort(); }
  return (T*)p;
}
template <class F, class... A>
void emu_launch(int grid, int threads, int smem, cudaStream_t, F f,
                A... args) {
  if (threads > 1024 || threads % 32 || smem > (int)sizeof(g_smem)) {
    fprintf(stderr, "bad launch\n");
    abort();
  }
  for (int b = 0; b < grid; ++b) {
    std::barrier<> block(threads);
    std::vector<std::unique_ptr<WarpX>> warps;
    for (int w = 0; w < threads / 32; ++w) warps.emplace_back(new WarpX);
    std::memset(g_smem, 0x7f, smem);  // stale bits, not zeros
    std::vector<std::thread> ts;
    for (int t = 0; t < threads; ++t)
      ts.emplace_back([&, t] {
        threadIdx.x = t;
        blockIdx.x = b;
        blockDim.x = threads;
        t_warp = warps[t / 32].get();
        t_block = &block;
        t_lane = t & 31;
        f(args...);
      });
    for (auto& th : ts) th.join();
  }
}
'''

MAIN_CPP = r'''
#include "amino.cpp"
// argv: in.bin out.bin; in.bin: kind (0 Forward, 1 posterior), H, Kpad,
// n, then em, tv, res, off, xv
int main(int, char** argv) {
  FILE* f = fopen(argv[1], "rb");
  int hd[4];
  if (fread(hd, 4, 4, f) != 4) return 3;
  const int kind = hd[0], H = hd[1], Kpad = hd[2], n = hd[3];
  std::vector<float> em((size_t)H * 21 * Kpad), tv((size_t)H * 11 * Kpad),
      xv(H * 10);
  std::vector<int> res(n + 1), off(H + 1);
  size_t got = fread(em.data(), 4, em.size(), f);
  got += fread(tv.data(), 4, tv.size(), f);
  got += fread(res.data(), 4, n, f);
  got += fread(off.data(), 4, H + 1, f);
  got += fread(xv.data(), 4, xv.size(), f);
  fclose(f);
  if (got != em.size() + tv.size() + n + H + 1 + xv.size()) return 3;
  std::vector<float> odds(Kpad > 4096 ? (size_t)H * 9 * Kpad : 0);
  std::vector<float> out(kind ? (size_t)H * (3 + Kpad) : H);
  std::vector<float> Mf((size_t)n * Kpad + 4), If((size_t)n * Kpad + 4),
      Xf((size_t)n * 4 + 4);
  const int rc = kind
      ? dtt_amino_posterior(em.data(), tv.data(), res.data(), off.data(),
                            xv.data(), odds.empty() ? nullptr : odds.data(),
                            out.data(), Mf.data(), If.data(), Xf.data(), H,
                            Kpad, nullptr)
      : dtt_amino_forward(em.data(), tv.data(), res.data(), off.data(),
                          xv.data(), odds.empty() ? nullptr : odds.data(),
                          out.data(), H, Kpad, nullptr);
  if (rc) return 2;
  FILE* g = fopen(argv[2], "wb");
  fwrite(out.data(), 4, out.size(), g);
  fclose(g);
  return 0;
}
'''


def emulated_source() -> str:
    """csrc/amino_forward.cu in the stand-in's terms: the dynamic shared
    array a global buffer, launches through emu_launch, float4 casts
    checked."""
    src = (_build.CSRC / "amino_forward.cu").read_text()
    src = src.replace("extern __shared__ float4 s_dyn[];",
                      "float4* s_dyn = reinterpret_cast<float4*>(g_smem);")
    src, launches = re.subn(r"(\w+<[^<>]*>)\s*<<<([^>]*)>>>\(",
                            r"emu_launch(\2, \1, ", src)
    assert launches == 1
    return re.sub(r"reinterpret_cast<(const )?float4\*>\(",
                  r"chk4<\1float4>(", src)


@pytest.fixture(scope="module")
def emulator(tmp_path_factory):
    gxx = shutil.which("g++")
    if gxx is None:
        pytest.skip("needs g++ to compile the kernel source for the CPU")
    d = tmp_path_factory.mktemp("amino_emu")
    (d / "cuda_runtime.h").write_text(RUNTIME_H)
    (d / "amino.cpp").write_text(emulated_source())
    (d / "main.cpp").write_text(MAIN_CPP)
    subprocess.run([gxx, "-std=c++20", "-O1", "-pthread", f"-I{d}", "-o",
                    str(d / "amino"), str(d / "main.cpp")], check=True,
                   capture_output=True, timeout=300)

    def run(kind: int, a: dict) -> torch.Tensor:
        H, _, Kpad = a["em"].shape
        with open(d / "in.bin", "wb") as f:
            np.array([kind, H, Kpad, a["res"].shape[0]], np.int32).tofile(f)
            for k in ("em", "tv", "res", "off", "xv"):
                a[k].numpy().tofile(f)
        subprocess.run([str(d / "amino"), str(d / "in.bin"),
                        str(d / "out.bin")], check=True, timeout=300)
        out = torch.from_numpy(np.fromfile(d / "out.bin", np.float32))
        return out if kind == 0 else out.reshape(H, 3 + Kpad)
    return run


def assert_close_to_exact(got, plain, a):
    want = plain(**{k: v.double() if v.is_floating_point() else v
                    for k, v in a.items()}).float()
    scale = torch.ones_like(want)
    if want.dim() == 1:
        scale /= hf.LN2
    else:
        scale[:, 0] = 1 / hf.LN2
    torch.testing.assert_close(got * scale, want * scale, rtol=1e-4,
                               atol=1e-3)


# Kpad 16: one warp, 28 of its threads past Kpad; 128: one full warp; 256
# and 1024: 2 and 8 warps; 8192: the 1024-thread form with the odds in the
# launch's scratch
CASES = [(16, [1, 5, 30]), (128, [37, 1, 60]), (256, [50, 7]),
         (1024, [1, 40]), (8192, [1, 5])]


@pytest.mark.parametrize("Kpad,lens", CASES)
def test_emulated_kernels_match_plain(emulator, Kpad, lens):
    c = amino_hits(Kpad, lens, Kpad + 29, "cpu")
    a = {k: c[k] for k in ("em", "tv", "res", "off", "xv")}
    fwd = emulator(0, a)
    post = emulator(1, a)
    assert_close_to_exact(fwd, hf.amino_forward_plain, a)
    assert_close_to_exact(post, hf.amino_posterior_plain, a)
    np.testing.assert_allclose(post[:, 1:].double().sum(1).numpy(), lens,
                               rtol=1e-5)
    # a batch's rows are its hits launched alone
    off = a["off"].tolist()
    for h in range(len(lens)):
        one = dict(em=a["em"][h:h + 1], tv=a["tv"][h:h + 1],
                   res=a["res"][off[h]:off[h + 1]].contiguous(),
                   off=torch.tensor([0, lens[h]], dtype=torch.int32),
                   xv=a["xv"][h:h + 1])
        assert torch.equal(emulator(1, one), post[h:h + 1])


def test_emulated_source_is_the_kernel_source():
    src = emulated_source()
    assert "emu_launch(" in src and "<<<" not in src
    assert "reinterpret_cast<const float4*>" not in src
