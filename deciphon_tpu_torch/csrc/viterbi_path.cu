// Phase-2 path kernel (B2): the packed backpointer trellis of every
// (pair, slot) window, pull-form Viterbi with the reference's
// first-minimum-wins candidate order.
//
// Replaces deciphon_tpu/ops/viterbi_pallas.py `_kernel_path` (reached
// through `_paths_pairs_core` and `viterbi_paths_pairs`), with the
// `_ck_end_from_starts` gather fused: the END-indexed row of position l and
// duration t is codes_all[clamp(starts[n, w] + l - t, 0, T - 1), t - 1].
//
// Mapping.  One CTA per real window (blockIdx = (slot, pair); length-0
// slots exit), the position loop inside the block, the Kp lanes split into
// consecutive chunks, one per thread.  The 5-slot M/I/D rings (15 x Kp
// f32) plus per-position scratch (new M, new I, packed codes: 3 x Kp) live
// in shared memory when they fit (Kp <= 2816, 256 threads) and otherwise
// in a global scratch slice per CTA, read through L1/L2 (1024 threads, at
// most 17 lanes a thread up to the large-K tier's Kp 16896); the same code
// runs on either pointer.  Special-state rings sit in registers, computed redundantly by
// every thread, with static ring slots from a 5-phase unrolled loop.
// Output: xnode (N, W, Lk) and node (N, W, Lk, Kp) int32, row l-1 holding
// position l; rows at or past a window's length are not written (the walk
// never reads them), and positions past Lk are not run.
//
// What bounds it.  Like B1, latency per position (lane shift, block-wide
// prefix min, three block-wide reductions for E and its argmin) plus the
// Kp int32 trellis row written per position; survivors are few, so this
// kernel is off the throughput path.
//
// Exactness.  Candidate values are (state + trans) + emission in the
// reference's f32 order; t runs 5..1, then BM, MM, IM, DM and II, MI, with
// a strict `<` so the first minimum wins; field codes are choice*5 + t-1,
// initialised to the first candidate (bm 4, bi 9, n/j/c 4) so unreachable
// rows still match; e_field = 2*k_first + (1 - m_at_k) over all Kp lanes;
// D = cummin(A - DDCUM) + DDCUM and the D bit is D < A.  xnode bits:
// N(4@0) B(2@4) E(15@6) C(4@21) T(1@25) J(4@26); node: M(5@0) D(1@5) I(4@6).
#include "common.cuh"

namespace {

using namespace dtt;

__device__ __forceinline__ void consider(float& best, int& code, float cand,
                                         int c) {
  if (cand < best) code = c;
  best = fminf(best, cand);
}

constexpr int kPathThreads = 256;       // rings in shared memory
constexpr int kPathWideThreads = 1024;  // rings in the global scratch

template <int kThreads>
__global__ void __launch_bounds__(kThreads) path_pairs_kernel(
    const int* __restrict__ pidx, const float* __restrict__ tables,
    const float* __restrict__ tvecs, const float* __restrict__ xts,
    const int* __restrict__ lens, const int* __restrict__ starts,
    const int* __restrict__ codes, int* __restrict__ xnode,
    int* __restrict__ node, float* __restrict__ scratch, int W, int Kp,
    int T, int Lk, int lpt) {
  extern __shared__ float smem[];
  __shared__ float red[kMaxWarps];
  __shared__ int redi[kMaxWarps];
  const int n = blockIdx.y, w = blockIdx.x;
  const int sw = n * W + w;
  const int len = min(lens[sw], Lk);  // the trellis holds Lk positions
  if (len <= 0) return;
  const float INF = inf_f();
  float* buf = scratch ? scratch + (size_t)sw * 18 * Kp : smem;
  float* Mr = buf;             // [5][Kp]
  float* Ir = Mr + 5 * Kp;     // [5][Kp]
  float* Dr = Ir + 5 * Kp;     // [5][Kp]
  float* Mn = Dr + 5 * Kp;     // [Kp] M of this position
  float* In = Mn + Kp;         // [Kp] I of this position
  int* cd = reinterpret_cast<int*>(In + Kp);  // [Kp] M|I codes

  const int p = pidx[n];
  const float* table = tables + (size_t)p * kTableRows * Kp;
  const float* tv = tvecs + (size_t)p * 8 * Kp;
  const float* tBM = tv + TV_BM * Kp;
  const float* tMMS = tv + TV_MMS * Kp;
  const float* tIMS = tv + TV_IMS * Kp;
  const float* tDMS = tv + TV_DMS * Kp;
  const float* tII = tv + TV_II * Kp;
  const float* tMI = tv + TV_MI * Kp;
  const float* tMD = tv + TV_MD * Kp;
  const float* tDDC = tv + TV_DDCUM * Kp;
  float xt[13];
#pragma unroll
  for (int j = 0; j < 13; ++j) xt[j] = xts[(size_t)sw * 16 + j];
  const int start = starts[sw];
  const int k0 = min((int)threadIdx.x * lpt, Kp);
  const int k1 = min(k0 + lpt, Kp);
  int* xrow = xnode + (size_t)sw * Lk;
  int* nrow = node + (size_t)sw * Lk * Kp;

  for (int k = threadIdx.x; k < 15 * Kp; k += blockDim.x) Mr[k] = INF;
  // special rings [S B N J C E] x 5 slots; slot 0 holds position 0
  float sml[6][5];
#pragma unroll
  for (int i = 0; i < 6; ++i)
#pragma unroll
    for (int j = 0; j < 5; ++j) sml[i][j] = INF;
  sml[0][0] = 0.f;
  sml[1][0] = xt[XT_SB];
  __syncthreads();

  for (int l0 = 0; l0 < len; l0 += 5) {
#pragma unroll
    for (int r = 0; r < 5; ++r) {
      const int l = l0 + r + 1;  // l % 5 == (r + 1) % 5
      if (l > len) break;
      const float* er[6];  // er[t]: row of the duration-t fragment ending at l
#pragma unroll
      for (int t = 1; t <= 5; ++t) {
        const int row = min(max(start + l - t, 0), T - 1);
        er[t] = table + (size_t)codes[(size_t)row * 5 + t - 1] * Kp;
      }

      // ---- M and I candidates, t descending ---------------------------
      for (int k = k0; k < k1; ++k) {
        const int km = k == 0 ? Kp - 1 : k - 1;
        float bm = INF, bi = INF;
        int bmc = 0 * 5 + 4, bic = 5 + 4;
#pragma unroll
        for (int t = 5; t >= 1; --t) {
          const int s = (r + 1 - t + 10) % 5;  // (l - t + 10) % 5
          const float ma = er[t][k];
          const float bg = er[t][Kp - 1];
          const float* M_ = Mr + s * Kp;
          const float* I_ = Ir + s * Kp;
          const float* D_ = Dr + s * Kp;
          consider(bm, bmc, (sml[1][s] + tBM[k]) + ma, 0 * 5 + (t - 1));
          consider(bm, bmc, (M_[km] + tMMS[km]) + ma, 1 * 5 + (t - 1));
          consider(bm, bmc, (I_[km] + tIMS[km]) + ma, 2 * 5 + (t - 1));
          consider(bm, bmc, (D_[km] + tDMS[km]) + ma, 3 * 5 + (t - 1));
          consider(bi, bic, (I_[k] + tII[k]) + bg, 5 + (t - 1));
          consider(bi, bic, (M_[k] + tMI[k]) + bg, 0 + (t - 1));
        }
        Mn[k] = bm;
        In[k] = bi;
        cd[k] = bmc | (bic << 6);
      }
      // ---- N, J, C candidates (every thread) ---------------------------
      float bn = INF, bj = INF, bc = INF;
      int nc = 4, jc = 4, cc = 4;
#pragma unroll
      for (int t = 5; t >= 1; --t) {
        const int s = (r + 1 - t + 10) % 5;
        const float nil = er[t][Kp - 2];
        consider(bn, nc, (sml[0][s] + xt[XT_SN]) + nil, 0 + (t - 1));
        consider(bn, nc, (sml[2][s] + xt[XT_NN]) + nil, 5 + (t - 1));
        consider(bj, jc, (sml[5][s] + xt[XT_EJ]) + nil, 0 + (t - 1));
        consider(bj, jc, (sml[3][s] + xt[XT_JJ]) + nil, 5 + (t - 1));
        consider(bc, cc, (sml[5][s] + xt[XT_EC]) + nil, 0 + (t - 1));
        consider(bc, cc, (sml[4][s] + xt[XT_CC]) + nil, 5 + (t - 1));
      }
      __syncthreads();

      // ---- delete chain, D backpointer, ring writes --------------------
      const int slot = (r + 1) % 5;
      float loc = INF;
      for (int k = k0; k < k1; ++k) {
        const int km = k == 0 ? Kp - 1 : k - 1;
        loc = fminf(loc, (Mn[km] + tMD[k]) - tDDC[k]);
      }
      float run = block_excl_prefix_min(loc, red);
      float vmin = INF;
      int* nout = nrow + (size_t)(l - 1) * Kp;
      for (int k = k0; k < k1; ++k) {
        const int km = k == 0 ? Kp - 1 : k - 1;
        const float A = Mn[km] + tMD[k];
        run = fminf(run, A - tDDC[k]);
        const float D = run + tDDC[k];
        nout[k] = cd[k] | ((D < A ? 1 : 0) << 5);
        Mr[slot * Kp + k] = Mn[k];
        Ir[slot * Kp + k] = In[k];
        Dr[slot * Kp + k] = D;
        vmin = fminf(vmin, fminf(Mn[k], D));
      }
      const float E = block_min(vmin, red);
      int kf = 1 << 30;
      for (int k = k0; k < k1; ++k) {
        if (fminf(Mr[slot * Kp + k], Dr[slot * Kp + k]) == E) {
          kf = k;
          break;
        }
      }
      const int k_first = block_min_int(kf, redi);
      const int m_at_k = Mr[slot * Kp + k_first] == E ? 1 : 0;
      const int e_field = 2 * k_first + (1 - m_at_k);

      // ---- B / T argmins -----------------------------------------------
      float B = INF, Tl = INF;
      int b_field = 1, t_field = 0;
      consider(B, b_field, bn + xt[XT_NB], 1);
      consider(B, b_field, E + xt[XT_EB], 2);
      consider(B, b_field, bj + xt[XT_JB], 3);
      consider(Tl, t_field, E + xt[XT_ET], 0);
      consider(Tl, t_field, bc + xt[XT_CT], 1);
      if (threadIdx.x == 0)
        xrow[l - 1] = nc | (b_field << 4) | (e_field << 6) | (cc << 21) |
                      (t_field << 25) | (jc << 26);
      sml[0][slot] = INF;
      sml[1][slot] = B;
      sml[2][slot] = bn;
      sml[3][slot] = bj;
      sml[4][slot] = bc;
      sml[5][slot] = E;
    }
  }
}

}  // namespace

// Ring + scratch bytes of one CTA (shared memory, or its global slice when
// the caller passes `scratch`: ops/viterbi.py PATH_SMEM_BYTES decides).
static size_t path_buf_bytes(int Kp) { return (size_t)18 * Kp * sizeof(float); }

extern "C" int dtt_path_pairs(
    const void* pidx, const void* tables, const void* tvecs, const void* xts,
    const void* lens, const void* starts, const void* codes, void* xnode,
    void* node, void* scratch, int N, int W, int Kp, int T, int Lk,
    void* stream) {
  const int threads = Kp < kPathThreads ? Kp : kPathThreads;
  const int lpt = (Kp + threads - 1) / threads;
  if (N <= 0 || W <= 0) return (int)cudaGetLastError();
  const dim3 grid(W, N);
  if (scratch) {
    const int wide = Kp < kPathWideThreads ? Kp : kPathWideThreads;
    path_pairs_kernel<kPathWideThreads>
        <<<grid, wide, 0, (cudaStream_t)stream>>>(
            (const int*)pidx, (const float*)tables, (const float*)tvecs,
            (const float*)xts, (const int*)lens, (const int*)starts,
            (const int*)codes, (int*)xnode, (int*)node, (float*)scratch, W,
            Kp, T, Lk, (Kp + wide - 1) / wide);
    return (int)cudaGetLastError();
  }
  const size_t smem = path_buf_bytes(Kp);
  cudaError_t err = cudaFuncSetAttribute(
      path_pairs_kernel<kPathThreads>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  path_pairs_kernel<kPathThreads><<<grid, threads, smem,
                                    (cudaStream_t)stream>>>(
      (const int*)pidx, (const float*)tables, (const float*)tvecs,
      (const float*)xts, (const int*)lens, (const int*)starts,
      (const int*)codes, (int*)xnode, (int*)node, (float*)scratch, W, Kp, T,
      Lk, lpt);
  return (int)cudaGetLastError();
}
