// Pull-form Viterbi kernels: the phase-2 path kernel (B2), the packed
// backpointer trellis of every (pair, slot) window, and its trellis-off
// instance, the dense-grid score kernel (B9), the alt cost T and the null
// cost R of every (profile, window) pair.
//
// B2 replaces deciphon_tpu/ops/viterbi_pallas.py `_kernel_path` (reached
// through `_paths_pairs_core` and `viterbi_paths_pairs`), with the
// `_ck_end_from_starts` gather fused: the END-indexed row of position l and
// duration t is codes_all[clamp(starts[n, w] + l - t, 0, T - 1), t - 1].
// B9 replaces `_kernel` (the pull-form score kernel of `_scores_grid_jit`,
// `viterbi_scores_grid` and `PallasScanEngine`) in every gather mode
// (slot, tregs, static: TPU layouts of one computation).  It reads the
// same start-indexed code buffer through per-window `starts`; the caller
// (ops/viterbi.py GridScanEngine) builds it from end-indexed codes.
//
// Mapping.  One CTA per real window (B2: blockIdx = (slot, pair), the
// profile pidx[pair]; B9: blockIdx = (window, profile), the windows shared
// by every profile; length-0 slots exit, B9 writing +inf first), the
// position loop inside the block, the Kp lanes split into consecutive
// chunks, one per thread.  The 5-slot M/I/D rings (15 x Kp f32) plus
// per-position scratch (new M, new I, packed codes: 3 x Kp) live in shared
// memory when they fit (Kp <= 2816, 256 threads) and otherwise in a global
// scratch slice per CTA, read through L1/L2 (1024 threads, at most 17
// lanes a thread up to the large-K tier's Kp 16896); the same code runs on
// either pointer.  Special-state rings (and B9's null ring R) sit in
// registers, computed redundantly by every thread, with static ring slots
// from a 5-phase unrolled loop.  B2's output: xnode (N, W, Lk) and node
// (N, W, Lk, Kp) int32, row l-1 holding position l; rows at or past a
// window's length are not written (the walk never reads them), and
// positions past Lk are not run.  B9's: alt and null (P, B) f32, T and R
// captured where l == length.
//
// What bounds it.  Latency per position (lane shift, block-wide prefix
// min, block-wide reductions for E and, in B2, its argmin), plus B2's Kp
// int32 trellis row per position.  B9 reads 5 ring slots of M/I/D per
// position and redoes the shift and min on each, about twice the push
// form's (B1's) adds and mins per cell; it runs every pair of a dense
// grid, so at full width it is the one kernel of this file whose
// throughput counts.
//
// Exactness.  B2: candidate values are (state + trans) + emission in the
// reference's f32 order; t runs 5..1, then BM, MM, IM, DM and II, MI, with
// a strict `<` so the first minimum wins; field codes are choice*5 + t-1,
// initialised to the first candidate (bm 4, bi 9, n/j/c 4) so unreachable
// rows still match; e_field = 2*k_first + (1 - m_at_k) over all Kp lanes;
// D = cummin(A - DDCUM) + DDCUM and the D bit is D < A.  xnode bits:
// N(4@0) B(2@4) E(15@6) C(4@21) T(1@25) J(4@26); node: M(5@0) D(1@5) I(4@6).
// B9 keeps `_kernel`'s grouping: min(shift1(min(M+MMs, I+IMs, D+DMs)),
// B+BM) + ma, min(I+II, M+MI) + bg, min(S+SN, N+NN) + nil and
// min_t(R_{l-t} + nil_t) + RR; rounding is monotone, so min(a, b) + e ==
// min(a + e, b + e) and M, I, N, J, C equal B2's values bit for bit, and
// T and R equal B1's (the push form) and the Pallas kernel's.  Built with
// -ftz=false -fmad=false (_build.py).
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

// kTrellis: B2 (pidx per pair, xts/lens/starts per (pair, slot), trellis
// out).  !kTrellis: B9 (profile = blockIdx.y, xts/lens/starts per window
// = blockIdx.x, alt/nul out per (profile, window); pidx, xnode, node
// unused, Lk ignored).
template <int kThreads, bool kTrellis>
__global__ void __launch_bounds__(kThreads) pull_kernel(
    const int* __restrict__ pidx, const float* __restrict__ tables,
    const float* __restrict__ tvecs, const float* __restrict__ xts,
    const int* __restrict__ lens, const int* __restrict__ starts,
    const int* __restrict__ codes, int* __restrict__ xnode,
    int* __restrict__ node, float* __restrict__ alt, float* __restrict__ nul,
    float* __restrict__ scratch, int W, int Kp, int T, int Lk, int lpt) {
  extern __shared__ float smem[];
  __shared__ float red[kMaxWarps];
  __shared__ int redi[kMaxWarps];
  const int n = blockIdx.y, w = blockIdx.x;
  const int sw = n * W + w;              // output row
  const int iw = kTrellis ? sw : w;      // input window row
  const float INF = inf_f();
  const int len = kTrellis ? min(lens[sw], Lk) : lens[iw];
  if (len <= 0) {
    if (!kTrellis && threadIdx.x == 0) alt[sw] = nul[sw] = INF;
    return;
  }
  float* buf = scratch ? scratch + (size_t)sw * 18 * Kp : smem;
  float* Mr = buf;             // [5][Kp]
  float* Ir = Mr + 5 * Kp;     // [5][Kp]
  float* Dr = Ir + 5 * Kp;     // [5][Kp]
  float* Mn = Dr + 5 * Kp;     // [Kp] M of this position
  float* In = Mn + Kp;         // [Kp] I of this position
  int* cd = reinterpret_cast<int*>(In + Kp);  // [Kp] M|I codes (B2)

  const int p = kTrellis ? pidx[n] : n;
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
  for (int j = 0; j < 13; ++j) xt[j] = xts[(size_t)iw * 16 + j];
  const int start = starts[iw];
  const int k0 = min((int)threadIdx.x * lpt, Kp);
  const int k1 = min(k0 + lpt, Kp);
  int* xrow = kTrellis ? xnode + (size_t)sw * Lk : nullptr;
  int* nrow = kTrellis ? node + (size_t)sw * Lk * Kp : nullptr;

  for (int k = threadIdx.x; k < 15 * Kp; k += blockDim.x) Mr[k] = INF;
  // special rings [S B N J C E R] x 5 slots; slot 0 holds position 0
  float sml[7][5];
#pragma unroll
  for (int i = 0; i < 7; ++i)
#pragma unroll
    for (int j = 0; j < 5; ++j) sml[i][j] = INF;
  sml[0][0] = 0.f;
  sml[1][0] = xt[XT_SB];
  sml[6][0] = -xt[XT_RR];
  float Tfin = INF, Rfin = INF;
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
          if constexpr (kTrellis) {
            consider(bm, bmc, (sml[1][s] + tBM[k]) + ma, 0 * 5 + (t - 1));
            consider(bm, bmc, (M_[km] + tMMS[km]) + ma, 1 * 5 + (t - 1));
            consider(bm, bmc, (I_[km] + tIMS[km]) + ma, 2 * 5 + (t - 1));
            consider(bm, bmc, (D_[km] + tDMS[km]) + ma, 3 * 5 + (t - 1));
            consider(bi, bic, (I_[k] + tII[k]) + bg, 5 + (t - 1));
            consider(bi, bic, (M_[k] + tMI[k]) + bg, 0 + (t - 1));
          } else {
            const float inner = fminf(
                fminf(M_[km] + tMMS[km], I_[km] + tIMS[km]),
                D_[km] + tDMS[km]);
            bm = fminf(bm, fminf(inner, sml[1][s] + tBM[k]) + ma);
            bi = fminf(bi, fminf(I_[k] + tII[k], M_[k] + tMI[k]) + bg);
          }
        }
        Mn[k] = bm;
        In[k] = bi;
        if constexpr (kTrellis) cd[k] = bmc | (bic << 6);
      }
      // ---- N, J, C (and B9's R) candidates (every thread) --------------
      float bn = INF, bj = INF, bc = INF, br = INF;
      int nc = 4, jc = 4, cc = 4;
#pragma unroll
      for (int t = 5; t >= 1; --t) {
        const int s = (r + 1 - t + 10) % 5;
        const float nil = er[t][Kp - 2];
        if constexpr (kTrellis) {
          consider(bn, nc, (sml[0][s] + xt[XT_SN]) + nil, 0 + (t - 1));
          consider(bn, nc, (sml[2][s] + xt[XT_NN]) + nil, 5 + (t - 1));
          consider(bj, jc, (sml[5][s] + xt[XT_EJ]) + nil, 0 + (t - 1));
          consider(bj, jc, (sml[3][s] + xt[XT_JJ]) + nil, 5 + (t - 1));
          consider(bc, cc, (sml[5][s] + xt[XT_EC]) + nil, 0 + (t - 1));
          consider(bc, cc, (sml[4][s] + xt[XT_CC]) + nil, 5 + (t - 1));
        } else {
          bn = fminf(bn, fminf(sml[0][s] + xt[XT_SN], sml[2][s] + xt[XT_NN])
                             + nil);
          bj = fminf(bj, fminf(sml[5][s] + xt[XT_EJ], sml[3][s] + xt[XT_JJ])
                             + nil);
          bc = fminf(bc, fminf(sml[5][s] + xt[XT_EC], sml[4][s] + xt[XT_CC])
                             + nil);
          br = fminf(br, sml[6][s] + nil);
        }
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
      int* nout = kTrellis ? nrow + (size_t)(l - 1) * Kp : nullptr;
      for (int k = k0; k < k1; ++k) {
        const int km = k == 0 ? Kp - 1 : k - 1;
        const float A = Mn[km] + tMD[k];
        run = fminf(run, A - tDDC[k]);
        const float D = run + tDDC[k];
        if constexpr (kTrellis) nout[k] = cd[k] | ((D < A ? 1 : 0) << 5);
        Mr[slot * Kp + k] = Mn[k];
        Ir[slot * Kp + k] = In[k];
        Dr[slot * Kp + k] = D;
        vmin = fminf(vmin, fminf(Mn[k], D));
      }
      const float E = block_min(vmin, red);

      // ---- B / T (B2: with the argmins and the xnode word) -------------
      float B = INF, Tl = INF;
      if constexpr (kTrellis) {
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
        int b_field = 1, t_field = 0;
        consider(B, b_field, bn + xt[XT_NB], 1);
        consider(B, b_field, E + xt[XT_EB], 2);
        consider(B, b_field, bj + xt[XT_JB], 3);
        consider(Tl, t_field, E + xt[XT_ET], 0);
        consider(Tl, t_field, bc + xt[XT_CT], 1);
        if (threadIdx.x == 0)
          xrow[l - 1] = nc | (b_field << 4) | (e_field << 6) | (cc << 21) |
                        (t_field << 25) | (jc << 26);
      } else {
        B = fminf(fminf(bn + xt[XT_NB], E + xt[XT_EB]), bj + xt[XT_JB]);
        Tl = fminf(E + xt[XT_ET], bc + xt[XT_CT]);
        br = br + xt[XT_RR];
        if (l == len) {
          Tfin = Tl;
          Rfin = br;
        }
      }
      sml[0][slot] = INF;
      sml[1][slot] = B;
      sml[2][slot] = bn;
      sml[3][slot] = bj;
      sml[4][slot] = bc;
      sml[5][slot] = E;
      sml[6][slot] = br;
    }
  }
  if (!kTrellis && threadIdx.x == 0) {
    alt[sw] = Tfin;
    nul[sw] = Rfin;
  }
}

// Ring + scratch bytes of one CTA (shared memory, or its global slice when
// the caller passes `scratch`: ops/viterbi.py PATH_SMEM_BYTES decides).
size_t pull_buf_bytes(int Kp) { return (size_t)18 * Kp * sizeof(float); }

// One launch over a grid of (W, N) CTAs.
template <bool kTrellis>
int launch_pull(const void* pidx, const void* tables, const void* tvecs,
                const void* xts, const void* lens, const void* starts,
                const void* codes, void* xnode, void* node, void* alt,
                void* nul, void* scratch, int N, int W, int Kp, int T, int Lk,
                void* stream) {
  if (N <= 0 || W <= 0) return (int)cudaGetLastError();
  const dim3 grid(W, N);
  if (scratch) {
    const int wide = Kp < kPathWideThreads ? Kp : kPathWideThreads;
    pull_kernel<kPathWideThreads, kTrellis>
        <<<grid, wide, 0, (cudaStream_t)stream>>>(
            (const int*)pidx, (const float*)tables, (const float*)tvecs,
            (const float*)xts, (const int*)lens, (const int*)starts,
            (const int*)codes, (int*)xnode, (int*)node, (float*)alt,
            (float*)nul, (float*)scratch, W, Kp, T, Lk,
            (Kp + wide - 1) / wide);
    return (int)cudaGetLastError();
  }
  const int threads = Kp < kPathThreads ? Kp : kPathThreads;
  const size_t smem = pull_buf_bytes(Kp);
  cudaError_t err = cudaFuncSetAttribute(
      pull_kernel<kPathThreads, kTrellis>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  pull_kernel<kPathThreads, kTrellis><<<grid, threads, smem,
                                        (cudaStream_t)stream>>>(
      (const int*)pidx, (const float*)tables, (const float*)tvecs,
      (const float*)xts, (const int*)lens, (const int*)starts,
      (const int*)codes, (int*)xnode, (int*)node, (float*)alt, (float*)nul,
      (float*)scratch, W, Kp, T, Lk, (Kp + threads - 1) / threads);
  return (int)cudaGetLastError();
}

}  // namespace

// B2: N pairs of W slots, trellis of Lk rows per slot.
extern "C" int dtt_path_pairs(
    const void* pidx, const void* tables, const void* tvecs, const void* xts,
    const void* lens, const void* starts, const void* codes, void* xnode,
    void* node, void* scratch, int N, int W, int Kp, int T, int Lk,
    void* stream) {
  return launch_pull<true>(pidx, tables, tvecs, xts, lens, starts, codes,
                           xnode, node, nullptr, nullptr, scratch, N, W, Kp,
                           T, Lk, stream);
}

// B9: every (profile, window) pair of P profiles and B windows.
extern "C" int dtt_score_grid(
    const void* tables, const void* tvecs, const void* xts, const void* lens,
    const void* starts, const void* codes, void* alt, void* nul,
    void* scratch, int P, int B, int Kp, int T, void* stream) {
  return launch_pull<false>(nullptr, tables, tvecs, xts, lens, starts, codes,
                            nullptr, nullptr, alt, nul, scratch, P, B, Kp, T,
                            0, stream);
}
