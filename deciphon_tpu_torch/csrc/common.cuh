// Shared device helpers of the deciphon_tpu_torch kernels.
//
// Min reductions and prefix mins are exact in any order, so the
// warp-shuffle trees below give the same f32 bits as the Pallas kernels'
// lane reductions.  Every helper ends with __syncthreads(), so its
// scratch can be reused by the next call without a race.
#pragma once

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

// The two segmented forms below serve the lane-packed kernels: the block's
// threads are cut into segments of `tps` consecutive threads (a multiple
// of 16), `sf` being the first thread of the caller's segment, and nothing
// crosses a segment boundary.  blockDim.x is a multiple of 32.

// Exclusive prefix min over the caller's segment in threadIdx order (+inf
// for the segment's first thread).
__device__ __forceinline__ float seg_excl_prefix_min(float v, float* red,
                                                     int sf) {
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  float incl = v;  // min over [max(sf, warp * 32), tid]
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const float u = __shfl_up_sync(kFull, incl, o);
    if (lane >= o && tid - o >= sf) incl = fminf(incl, u);
  }
  if (lane == 31) red[warp] = incl;
  __syncthreads();
  float excl = __shfl_up_sync(kFull, incl, 1);
  if (lane == 0 || tid - 1 < sf) excl = inf_f();
  // earlier warps that hold threads of this segment: their lane 31 lies
  // in it, and its inclusive min starts at the segment's first thread
  for (int i = sf >> 5; i < warp; ++i) excl = fminf(excl, red[i]);
  __syncthreads();
  return excl;
}

// Min over the caller's segment; every thread of the segment gets it.
__device__ __forceinline__ float seg_min(float v, float* red, int sf,
                                         int tps) {
  const int tid = threadIdx.x;
#pragma unroll
  for (int o = 8; o > 0; o >>= 1) v = fminf(v, __shfl_xor_sync(kFull, v, o));
  if ((tid & 15) == 0) red[tid >> 4] = v;
  __syncthreads();
  float r = inf_f();
  for (int i = sf >> 4; i < (sf + tps) >> 4; ++i) r = fminf(r, red[i]);
  __syncthreads();
  return r;
}

}  // namespace dtt
