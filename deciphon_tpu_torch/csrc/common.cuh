// Shared device helpers of the deciphon_tpu_torch kernels.
//
// Min reductions and prefix mins are exact in any order, so the
// warp-shuffle trees below give the same f32 bits as the Pallas kernels'
// lane reductions.  Every helper ends with __syncthreads(), so its
// scratch can be reused by the next call without a race.
#pragma once

#include <cooperative_groups.h>
#include <cuda_runtime.h>

namespace dtt {

constexpr unsigned kFull = 0xffffffffu;
constexpr int kTableRows = 1364;  // frame.TABLE_SIZE
constexpr int kMaxWarps = 32;

// transition-vector rows (deciphon_tpu_torch/ops/tables.py TV_*)
enum { TV_BM, TV_MMS, TV_MI, TV_MD, TV_IMS, TV_II, TV_DMS, TV_DDCUM };
// special-transition columns (deciphon_tpu/xtrans.py XT_*)
enum { XT_RR, XT_SN, XT_NN, XT_SB, XT_NB, XT_EB, XT_JB, XT_EJ, XT_JJ,
       XT_EC, XT_CC, XT_ET, XT_CT };

__device__ __forceinline__ float inf_f() { return __int_as_float(0x7f800000); }

// Block-wide min; every thread gets the result.
__device__ __forceinline__ float block_min(float v, float* red) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int nw = (blockDim.x + 31) >> 5;
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v = fminf(v, __shfl_xor_sync(kFull, v, o));
  if (lane == 0) red[warp] = v;
  __syncthreads();
  float r = red[0];
  for (int i = 1; i < nw; ++i) r = fminf(r, red[i]);
  __syncthreads();
  return r;
}

__device__ __forceinline__ int block_min_int(int v, int* red) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int nw = (blockDim.x + 31) >> 5;
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v = min(v, __shfl_xor_sync(kFull, v, o));
  if (lane == 0) red[warp] = v;
  __syncthreads();
  int r = red[0];
  for (int i = 1; i < nw; ++i) r = min(r, red[i]);
  __syncthreads();
  return r;
}

// Exclusive prefix min over threads in threadIdx order (+inf for thread 0).
// Threads own consecutive lane chunks in the same order, so this turns
// per-thread chunk mins into the carry-in of a lane-wise cummin.
__device__ __forceinline__ float block_excl_prefix_min(float v, float* red) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  float incl = v;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const float u = __shfl_up_sync(kFull, incl, o);
    if (lane >= o) incl = fminf(incl, u);
  }
  if (lane == 31) red[warp] = incl;
  __syncthreads();
  float excl = __shfl_up_sync(kFull, incl, 1);
  if (lane == 0) excl = inf_f();
  for (int i = 0; i < warp; ++i) excl = fminf(excl, red[i]);
  __syncthreads();
  return excl;
}

// ---- Helpers of the redesigned bodies (B1/B3/B5/B8 score body, B2) ------
//
// A thread owns LPT consecutive lanes [tid * LPT, tid * LPT + LPT); LPT is
// a compile-time constant (2 or 4), so a chunk lives in registers and
// moves as 16-byte (LPT % 4 == 0) or 8-byte accesses.  Kp is a multiple of
// 128 and every plane starts at a multiple of Kp floats, so chunks are
// aligned.

__device__ __forceinline__ int bits(float v) { return __float_as_int(v); }
__device__ __forceinline__ int bits(int v) { return v; }
__device__ __forceinline__ void unbits(float& v, int b) { v = __int_as_float(b); }
__device__ __forceinline__ void unbits(int& v, int b) { v = b; }

template <int LPT, typename V>
__device__ __forceinline__ void ld_chunk(V* v, const V* p) {
  static_assert(sizeof(V) == 4 && LPT % 2 == 0, "pairs of 32-bit lanes");
  if constexpr (LPT % 4 == 0) {
#pragma unroll
    for (int q = 0; q < LPT / 4; ++q) {
      const int4 x = reinterpret_cast<const int4*>(p)[q];
      unbits(v[4 * q], x.x);
      unbits(v[4 * q + 1], x.y);
      unbits(v[4 * q + 2], x.z);
      unbits(v[4 * q + 3], x.w);
    }
  } else {
#pragma unroll
    for (int q = 0; q < LPT / 2; ++q) {
      const int2 x = reinterpret_cast<const int2*>(p)[q];
      unbits(v[2 * q], x.x);
      unbits(v[2 * q + 1], x.y);
    }
  }
}

// The same through the read-only path, for inputs no thread writes.
template <int LPT>
__device__ __forceinline__ void ldg_chunk(float* v, const float* p) {
  static_assert(LPT % 2 == 0, "pairs of lanes");
  if constexpr (LPT % 4 == 0) {
#pragma unroll
    for (int q = 0; q < LPT / 4; ++q) {
      const float4 x = __ldg(reinterpret_cast<const float4*>(p) + q);
      v[4 * q] = x.x;
      v[4 * q + 1] = x.y;
      v[4 * q + 2] = x.z;
      v[4 * q + 3] = x.w;
    }
  } else {
#pragma unroll
    for (int q = 0; q < LPT / 2; ++q) {
      const float2 x = __ldg(reinterpret_cast<const float2*>(p) + q);
      v[2 * q] = x.x;
      v[2 * q + 1] = x.y;
    }
  }
}

template <int LPT, typename V>
__device__ __forceinline__ void st_chunk(V* p, const V* v) {
  static_assert(sizeof(V) == 4 && LPT % 2 == 0, "pairs of 32-bit lanes");
  if constexpr (LPT % 4 == 0) {
#pragma unroll
    for (int q = 0; q < LPT / 4; ++q)
      reinterpret_cast<int4*>(p)[q] = make_int4(
          bits(v[4 * q]),
          bits(v[4 * q + 1]),
          bits(v[4 * q + 2]),
          bits(v[4 * q + 3]));
  } else {
#pragma unroll
    for (int q = 0; q < LPT / 2; ++q)
      reinterpret_cast<int2*>(p)[q] =
          make_int2(bits(v[2 * q]), bits(v[2 * q + 1]));
  }
}

// Inclusive prefix min over the lanes of a warp, in lane order.
__device__ __forceinline__ float warp_incl_min(float v) {
  const int lane = threadIdx.x & 31;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const float u = __shfl_up_sync(kFull, v, o);
    if (lane >= o) v = fminf(v, u);
  }
  return v;
}

// The same restarted at segments of consecutive lanes: a lane combines
// only the lanes of its own segment, `first` being the index of the
// segment's first lane counted as `idx` counts this lane (idx - lane is
// the same in every lane of the warp).
__device__ __forceinline__ float warp_seg_incl_min(float v, int idx,
                                                   int first) {
  const int lane = threadIdx.x & 31;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const float u = __shfl_up_sync(kFull, v, o);
    if (lane >= o && idx - o >= first) v = fminf(v, u);
  }
  return v;
}

// Min over the lanes of a warp; every lane gets it.
__device__ __forceinline__ float warp_min(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v = fminf(v, __shfl_xor_sync(kFull, v, o));
  return v;
}

// Cross-warp part of a block-wide lane cummin that takes one barrier: each
// warp has stored, before the barrier, the min of its lane terms without
// the term of its first lane (part[w]) and the value its last lane hands
// to the next warp's first lane (hand[w]; hand[kMaxWarps] is lane Kp-1's,
// handed round to lane 0).  After the barrier every warp rebuilds every
// first-lane term x_i = (hand[i-1] + md_i) - ddc_i itself (lane i holds
// md_i and ddc_i, the first lane's MD and DDCUM values) and combines the
// warps before its own with one warp-wide load and a shuffle scan.
// Returns the min of every term before this warp's lanes; *xw gets this
// warp's own first-lane term.
__device__ __forceinline__ float cross_warp_carry(const float* part,
                                                  const float* hand,
                                                  float md_i, float ddc_i,
                                                  float* xw) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int nw = blockDim.x >> 5;
  float x = inf_f(), f = inf_f();
  if (lane < nw) {
    x = (hand[lane == 0 ? kMaxWarps : lane - 1] + md_i) - ddc_i;
    f = fminf(part[lane], x);
  }
  f = warp_incl_min(f);
  float before = __shfl_up_sync(kFull, f, 1);
  if (lane == 0) before = inf_f();
  *xw = __shfl_sync(kFull, x, warp);
  return __shfl_sync(kFull, before, warp);
}

// Lexicographic min of (value, key) over the lanes of a warp; every lane
// gets it.  Keys are distinct, so the order is total and the result the
// same in every lane.
__device__ __forceinline__ void key_min(float& v, int& k) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) {
    const float ov = __shfl_xor_sync(kFull, v, o);
    const int ok = __shfl_xor_sync(kFull, k, o);
    if (ov < v || (ov == v && ok < k)) {
      v = ov;
      k = ok;
    }
  }
}

// Own-lane staging of emission rows: LPT consecutive floats copied from
// global to shared memory by cp.async (16-byte copies bypass L1, 8-byte
// ones go through it).  The issuing thread alone reads them back, after
// cp_async_wait(), so no barrier is needed for the data itself.
template <int LPT>
__device__ __forceinline__ void cp_chunk(float* dst, const float* src) {
  static_assert(LPT % 2 == 0, "pairs of lanes");
  const unsigned s = (unsigned)__cvta_generic_to_shared(dst);
  if constexpr (LPT % 4 == 0) {
#pragma unroll
    for (int q = 0; q < LPT / 4; ++q)
      asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(
                       s + 16 * q),
                   "l"(src + 4 * q));
  } else {
#pragma unroll
    for (int q = 0; q < LPT / 2; ++q)
      asm volatile("cp.async.ca.shared.global [%0], [%1], 8;\n" ::"r"(
                       s + 8 * q),
                   "l"(src + 2 * q));
  }
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}


// ---- Thread-block clusters: the large-K forms of the bodies ------------
//
// A window too wide for one CTA's shared memory is split over a cluster of
// c CTAs (c <= kMaxCluster, along x): rank r owns lanes [r * w, min((r + 1)
// * w, Kp)), w = blockDim.x * LPT a multiple of 32 * LPT, so that only the
// last rank has dead warps (every lane of a warp past Kp).  Per-warp
// values cross CTAs through distributed shared memory (DSMEM) on cluster
// barriers.

constexpr int kMaxCluster = 16;

__device__ __forceinline__ int cluster_rank() {
  unsigned r;
  asm volatile("mov.u32 %0, %%cluster_ctarank;\n" : "=r"(r));
  return (int)r;
}

__device__ __forceinline__ int cluster_size() {
  unsigned n;
  asm volatile("mov.u32 %0, %%cluster_nctarank;\n" : "=r"(n));
  return (int)n;
}

// One barrier round over every thread of the cluster: shared-memory
// writes before the arrive are released to the cluster, and acquired by
// every thread past the wait (this CTA's own included).
__device__ __forceinline__ void cluster_sync() {
  asm volatile("barrier.cluster.arrive.release.aligned;\n" ::: "memory");
  asm volatile("barrier.cluster.wait.acquire.aligned;\n" ::: "memory");
}

// `p`, an address in this CTA's shared memory, in CTA `rank`'s.
template <typename T>
__device__ __forceinline__ T* at_rank(T* p, int rank) {
  return cooperative_groups::this_cluster().map_shared_rank(p, (unsigned)rank);
}

// Values cross CTAs by pushes: before a cluster barrier the owner of a
// per-warp value stores it into the exchange array of every CTA that
// needs it, at [its rank][its warp]; past the barrier each CTA reads its
// own copy, so no remote load sits on the path from one barrier to the
// next.

// Store v at `slot` (an address in this CTA's shared memory) in CTA ranks
// j0 .. j1 - 1.
template <typename T>
__device__ __forceinline__ void push(T* slot, T v, int j0, int j1) {
  for (int j = j0; j < j1; ++j) *at_rank(slot, j) = v;
}

// Min of `m` and v[j][i] over ranks j < nr and warps i < nw (lane i reads
// warp i's of each rank); every lane gets it.
__device__ __forceinline__ float ranks_min(const float (*v)[kMaxWarps],
                                           int nw, int nr, float m) {
  const int lane = threadIdx.x & 31;
  if (lane < nw) {
#pragma unroll
    for (int j = 0; j < kMaxCluster; ++j)
      if (j < nr) m = fminf(m, v[j][lane]);
  }
  return warp_min(m);
}

// key_min over the pushed (value, key) pairs of every rank and this
// lane's (bv, bk); every lane gets the result.
__device__ __forceinline__ void ranks_key_min(const float (*v)[kMaxWarps],
                                              const int (*k)[kMaxWarps],
                                              int nw, int nr, float& bv,
                                              int& bk) {
  const int lane = threadIdx.x & 31;
  if (lane < nw) {
#pragma unroll
    for (int j = 0; j < kMaxCluster; ++j) {
      if (j >= nr) break;
      const float x = v[j][lane];
      const int y = k[j][lane];
      if (x < bv || (x == bv && y < bk)) {
        bv = x;
        bk = y;
      }
    }
  }
  key_min(bv, bk);
}

}  // namespace dtt

// Host side: launch `kernel` on `grid` in clusters of c CTAs along x,
// after checking that at least one such cluster can be resident
// (cudaOccupancyMaxActiveClusters; a cluster must fit in one GPC).
// *active gets that count.  Returns a cudaError_t; a shape that cannot be
// resident gives cudaErrorLaunchOutOfResources and is not launched.
template <typename... KArgs, typename... Args>
inline int dtt_launch_clusters(void (*kernel)(KArgs...), dim3 grid, int c,
                               int threads, size_t smem, void* stream,
                               int* active, Args... args) {
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
  if (err != cudaSuccess) return (int)err;
  cudaLaunchAttribute attr;
  attr.id = cudaLaunchAttributeClusterDimension;
  attr.val.clusterDim.x = c;
  attr.val.clusterDim.y = 1;
  attr.val.clusterDim.z = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(c, 1, 1);  // one cluster, for the residency query
  cfg.blockDim = dim3(threads, 1, 1);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = (cudaStream_t)stream;
  cfg.attrs = &attr;
  cfg.numAttrs = 1;
  int n = 0;
  err = cudaOccupancyMaxActiveClusters(&n, (void*)kernel, &cfg);
  if (err != cudaSuccess) return (int)err;
  if (active) *active = n;
  if (n < 1) return (int)cudaErrorLaunchOutOfResources;
  if (grid.x == 0 || grid.y == 0) return (int)cudaGetLastError();
  cfg.gridDim = grid;
  err = cudaLaunchKernelEx(&cfg, kernel, args...);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}
