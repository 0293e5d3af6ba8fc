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
// Mapping (pull_kernel; path_kernel below differs as its note says).  One
// CTA per real window (B2: blockIdx = (slot, pair), the
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
// What bounds it.  Latency per position, plus B2's Kp int32 trellis row
// per position.  pull_kernel spends seven __syncthreads rounds a position
// (the shift, the prefix min, E and a separate reduction for E's first
// lane after a serial scan of the chunk), loads codes and then emission
// rows at the head of every position, reads transition rows inside the
// five-length candidate loop and stores the trellis row strided by the
// lanes a thread.  B2 up to Kp 2048 runs path_kernel instead: two rounds a
// position (the shift and the delete chain's cross-warp carry on the
// first, one reduction of the key (min(M, D), 2k + (M == min ? 0 : 1))
// for E and its field on the second), the next position's emission rows
// copied (cp.async) ahead of the first round, the transition rows in shared
// memory, 16-byte ring and trellis accesses, the N/J/C states in warp 0.
// On one H100 (700 W), B2 per position: 4.15 us at Kp 2048 (pull_kernel
// 16.88) and 2.75 us at Kp 1024 (6.19); past Kp 2048 B2 keeps pull_kernel
// (41.5 us at Kp 5376, global-scratch form).  B9 reads 5 ring slots of
// M/I/D per position and redoes the shift and min on each, about twice
// the push form's (B1's) adds and mins per cell; it runs every pair of a
// dense grid, so at full width it is the one kernel of this file whose
// throughput counts.  It keeps pull_kernel (ROADMAP: its registers).
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

// consider() into one field of a packed word: the M code at bit 0 (5
// bits), the I code at bit 6 (4 bits)
template <int kShift>
__device__ __forceinline__ void consider_at(float& best, int& word,
                                            float cand, int c) {
  constexpr int kMask = (kShift == 0 ? 31 : 15) << kShift;
  if (cand < best) word = (word & ~kMask) | (c << kShift);
  best = fminf(best, cand);
}

constexpr int kPathThreads = 256;       // rings in shared memory
constexpr int kPathWideThreads = 1024;  // rings in the global scratch
// The redesigned B2 (path_kernel) takes Kp up to kPathFastMaxKp with its
// rings in shared memory, LPT 2 lanes a thread up to kPathLpt2MaxKp and LPT
// 4 beyond (Kp / LPT threads, at most kPathFastThreads); past it B2 keeps
// pull_kernel.  Shared planes: M, I, D rings (15) | transition rows (8) |
// staged emission rows (5): 229,376 bytes at Kp 2048.
constexpr int kPathFastMaxKp = 2048;
constexpr int kPathLpt2MaxKp = 1024;
constexpr int kPathFastThreads = 512;
constexpr int kPathFastPlanes = 28;

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

// The redesigned B2 (rings in shared memory, Kp up to kPathFastMaxKp):
// blockDim.x * LPT == Kp, a thread owning LPT consecutive lanes.  Per
// position: the M and I candidates of the own lanes, reading the ring
// slots on those lanes and the left neighbour lane with 16-byte accesses;
// the next position's emission rows copied (cp.async) into a staging
// plane set on the own lanes (a thread stages and reads only its own
// lanes), their codes fetched a position earlier; the delete chain, whose
// warp scans and M hand-overs share one barrier (cross_warp_carry); the
// trellis row stored, the rings written, and one reduction of the key
// (min(M, D), 2k + (M == min ? 0 : 1)), which gives E and the xnode E
// field together, on the second barrier.  Transition rows sit in shared
// memory beside the rings; the N/J/C states are warp 0's.
template <int LPT>
__global__ void __launch_bounds__(kPathFastThreads, 1) path_kernel(
    const int* __restrict__ pidx, const float* __restrict__ tables,
    const float* __restrict__ tvecs, const float* __restrict__ xts,
    const int* __restrict__ lens, const int* __restrict__ starts,
    const int* __restrict__ codes, int* __restrict__ xnode,
    int* __restrict__ node, int W, int Kp, int T, int Lk) {
  extern __shared__ float smem[];
  __shared__ float xs[kMaxWarps];      // warp scans, first lane left out
  __shared__ float xm[kMaxWarps + 1];  // M handed on by each warp's last lane
  __shared__ float xe[kMaxWarps];      // warp minima of min(M, D) ...
  __shared__ int xk[kMaxWarps];        // ... and their keys
  __shared__ float xt[16];
  // The N, J, C special states are warp 0's: its lanes compute them
  // identically and keep their rings [N J C E] here, with the position's
  // C and its xnode codes; before the first barrier it hands N and J of
  // the position to the other warps (nj), which form B after the second.
  __shared__ float sr[4][5], nj[2], cpos;
  __shared__ int cwrd;
  const int n = blockIdx.y, w = blockIdx.x;
  const int sw = n * W + w;
  const int len = min(lens[sw], Lk);
  if (len <= 0) return;
  const float INF = inf_f();
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int nw = blockDim.x >> 5;
  const int k0 = tid * LPT;
  const bool last = k0 + LPT == Kp;
  const int nb = warp == 0 ? kMaxWarps : warp - 1;  // hand-over slot
  float* Mr = smem;          // [5][Kp] M of positions l-5..l-1
  float* Ir = Mr + 5 * Kp;   // [5][Kp]
  float* Dr = Ir + 5 * Kp;   // [5][Kp]
  float* TVs = Dr + 5 * Kp;  // [8][Kp] transition rows
  float* EMs = TVs + 8 * Kp; // [5][Kp] emission rows, duration t at t-1

  const int p = pidx[n];
  const float* table = tables + (size_t)p * kTableRows * Kp;
  const float* tv = tvecs + (size_t)p * 8 * Kp;
  for (int i = tid; i < 15 * Kp; i += blockDim.x) Mr[i] = INF;
#pragma unroll
  for (int q = 0; q < 8; ++q) {
    float v[LPT];
    ldg_chunk<LPT>(v, tv + q * Kp + k0);
    st_chunk<LPT>(TVs + q * Kp + k0, v);
  }
  // MD and DDCUM of warp `lane`'s first lane, for the cross-warp carry
  float md_w = INF, ddc_w = 0.f;
  if (lane < nw) {
    md_w = __ldg(tv + TV_MD * Kp + lane * 32 * LPT);
    ddc_w = __ldg(tv + TV_DDCUM * Kp + lane * 32 * LPT);
  }
  if (tid < 13) xt[tid] = xts[(size_t)sw * 16 + tid];
  const int start = starts[sw];

  // special rings x 5 slots, slot 0 holding position 0 (S is 0 at position
  // 0 and +inf after it): B block-wide (every thread stores the same
  // value after the second barrier; a slot is read by the candidates of
  // the next five positions, before it is stored again), N J C E warp 0's
  __shared__ float sb[5];
  if (tid < 5) sb[tid] = tid == 0 ? xts[(size_t)sw * 16 + XT_SB] : INF;
  if (warp == 0) {
#pragma unroll
    for (int j = 0; j < 20; ++j) sr[j / 5][j % 5] = INF;
  }

  // EMs plane t-1: the own lanes of the row of the duration-t fragment
  // ending at the position; codes of the position after it
  // The next position's bg (lane Kp-1) values stay in registers; its nil
  // (lane Kp-2) values and the codes of the position after it are loaded
  // behind the first barrier and parked after the second in the warp's
  // own copy (every lane stores the same values).
  __shared__ float wst[kMaxWarps][15];
  float* ws = wst[warp];  // nil of duration t at 4 + t, codes at 9 + t
  float bgr[5], nlr[5];
  int cn[5];
  auto codes_of = [&](int l) {
#pragma unroll
    for (int t = 1; t <= 5; ++t) {
      const int row = min(max(start + l - t, 0), T - 1);
      cn[t - 1] = __ldg(codes + (size_t)row * 5 + t - 1);
    }
  };
  auto fetch = [&]() {
#pragma unroll
    for (int t = 0; t < 5; ++t) {
      const float* er = table + (size_t)cn[t] * Kp;
      cp_chunk<LPT>(EMs + t * Kp + k0, er + k0);
      bgr[t] = __ldg(er + Kp - 1);
      nlr[t] = __ldg(er + Kp - 2);
    }
    cp_async_commit();
  };
  auto park = [&]() {
#pragma unroll
    for (int t = 0; t < 5; ++t) {
      ws[5 + t] = nlr[t];
      ws[10 + t] = __int_as_float(cn[t]);
    }
  };
  codes_of(1);
  fetch();
  codes_of(2);
  park();
  __syncthreads();

  for (int l0 = 0; l0 < len; l0 += 5) {
#pragma unroll
    for (int r = 0; r < 5; ++r) {
      const int l = l0 + r + 1;  // l % 5 == (r + 1) % 5
      if (l > len) break;

      // ---- M and I candidates, t descending (own lanes) -------------
      float Mn[LPT], In[LPT];
      int cd[LPT];
      cp_async_wait();  // this position's emission rows
      {
        const int km0 = k0 == 0 ? Kp - 1 : k0 - 1;  // the left neighbour
        float bmt[LPT], ii[LPT], mi[LPT];
        float mms[LPT + 1], ims[LPT + 1], dms[LPT + 1];  // lanes k0-1..
        ld_chunk<LPT>(bmt, TVs + TV_BM * Kp + k0);
        ld_chunk<LPT>(ii, TVs + TV_II * Kp + k0);
        ld_chunk<LPT>(mi, TVs + TV_MI * Kp + k0);
        mms[0] = TVs[TV_MMS * Kp + km0];
        ims[0] = TVs[TV_IMS * Kp + km0];
        dms[0] = TVs[TV_DMS * Kp + km0];
        ld_chunk<LPT>(mms + 1, TVs + TV_MMS * Kp + k0);
        ld_chunk<LPT>(ims + 1, TVs + TV_IMS * Kp + k0);
        ld_chunk<LPT>(dms + 1, TVs + TV_DMS * Kp + k0);
#pragma unroll
        for (int j = 0; j < LPT; ++j) {
          Mn[j] = In[j] = INF;
          cd[j] = (0 * 5 + 4) | ((5 + 4) << 6);  // M code | I code << 6
        }
#pragma unroll
        for (int t = 5; t >= 1; --t) {
          const int s = (r + 1 - t + 10) % 5;  // (l - t + 10) % 5
          float Mx[LPT + 1], Ix[LPT + 1], Dx[LPT + 1];  // lanes k0-1..
          Mx[0] = Mr[s * Kp + km0];
          Ix[0] = Ir[s * Kp + km0];
          Dx[0] = Dr[s * Kp + km0];
          ld_chunk<LPT>(Mx + 1, Mr + s * Kp + k0);
          ld_chunk<LPT>(Ix + 1, Ir + s * Kp + k0);
          ld_chunk<LPT>(Dx + 1, Dr + s * Kp + k0);
          const float Bs = sb[s], bgt = bgr[t - 1];
          float em[LPT];
          ld_chunk<LPT>(em, EMs + (t - 1) * Kp + k0);
#pragma unroll
          for (int j = 0; j < LPT; ++j) {
            const float ma = em[j];
            consider_at<0>(Mn[j], cd[j], (Bs + bmt[j]) + ma, 0 * 5 + (t - 1));
            consider_at<0>(Mn[j], cd[j], (Mx[j] + mms[j]) + ma, 1 * 5 + (t - 1));
            consider_at<0>(Mn[j], cd[j], (Ix[j] + ims[j]) + ma, 2 * 5 + (t - 1));
            consider_at<0>(Mn[j], cd[j], (Dx[j] + dms[j]) + ma, 3 * 5 + (t - 1));
            consider_at<6>(In[j], cd[j], (Ix[j + 1] + ii[j]) + bgt, 5 + (t - 1));
            consider_at<6>(In[j], cd[j], (Mx[j + 1] + mi[j]) + bgt, 0 + (t - 1));
          }
        }
      }
      // ---- N, J, C candidates (warp 0) ----------------------------------
      if (warp == 0) {
        float bn = INF, bj = INF, bc = INF;
        int nc = 4, jc = 4, cc = 4;
#pragma unroll
        for (int t = 5; t >= 1; --t) {
          const int s = (r + 1 - t + 10) % 5;
          const float nl = ws[4 + t];
          const float S = (l0 == 0 && r + 1 == t) ? 0.f : INF;
          consider(bn, nc, (S + xt[XT_SN]) + nl, 0 + (t - 1));
          consider(bn, nc, (sr[0][s] + xt[XT_NN]) + nl, 5 + (t - 1));
          consider(bj, jc, (sr[3][s] + xt[XT_EJ]) + nl, 0 + (t - 1));
          consider(bj, jc, (sr[1][s] + xt[XT_JJ]) + nl, 5 + (t - 1));
          consider(bc, cc, (sr[3][s] + xt[XT_EC]) + nl, 0 + (t - 1));
          consider(bc, cc, (sr[2][s] + xt[XT_CC]) + nl, 5 + (t - 1));
        }
        nj[0] = bn;
        nj[1] = bj;
        cpos = bc;
        cwrd = nc | (cc << 21) | (jc << 26);
      }
      // this thread has read its lanes of this position's staged rows:
      // stage l+1's (a thread stages and reads only its own lanes), then
      // fetch the codes of l+2
#pragma unroll
      for (int t = 0; t < 5; ++t) cn[t] = __float_as_int(ws[10 + t]);
      fetch();
      codes_of(l + 2);

      // ---- delete chain (barrier 1) ------------------------------------
      float md[LPT], ddc[LPT];
      ld_chunk<LPT>(md, TVs + TV_MD * Kp + k0);
      ld_chunk<LPT>(ddc, TVs + TV_DDCUM * Kp + k0);
      const float mb = __shfl_up_sync(kFull, Mn[LPT - 1], 1);
      float loc = INF;
#pragma unroll
      for (int j = 0; j < LPT; ++j) {
        if (j == 0 && lane == 0) continue;  // its neighbour is another warp's
        const float A = (j == 0 ? mb : Mn[j - 1]) + md[j];
        loc = fminf(loc, A - ddc[j]);
      }
      const float incl = warp_incl_min(loc);
      float run = __shfl_up_sync(kFull, incl, 1);
      if (lane == 31) {
        xs[warp] = incl;
        xm[warp] = Mn[LPT - 1];
      }
      if (last) xm[kMaxWarps] = Mn[LPT - 1];
      __syncthreads();
      float xw;
      const float before = cross_warp_carry(xs, xm, md_w, ddc_w, &xw);
      const float bn = nj[0], bj = nj[1];
      run = lane == 0 ? before : fminf(fminf(before, xw), run);
      const float nbm = lane == 0 ? xm[nb] : mb;

      // ---- D, the trellis row, the rings, the E key (barrier 2) --------
      const int slot = (r + 1) % 5;
      float Dn[LPT], bv = INF;
      int nd[LPT], bk = 0;
#pragma unroll
      for (int j = 0; j < LPT; ++j) {
        const float A = (j == 0 ? nbm : Mn[j - 1]) + md[j];
        run = fminf(run, A - ddc[j]);
        const float D = run + ddc[j];
        Dn[j] = D;
        nd[j] = cd[j] | ((D < A ? 1 : 0) << 5);
        const float v = fminf(Mn[j], D);
        const int key = 2 * (k0 + j) + (Mn[j] == v ? 0 : 1);
        if (j == 0 || v < bv) {  // lanes ascend: the first minimum wins
          bv = v;
          bk = key;
        }
      }
      st_chunk<LPT>(node + ((size_t)sw * Lk + l - 1) * Kp + k0, nd);
      st_chunk<LPT>(Mr + slot * Kp + k0, Mn);
      st_chunk<LPT>(Ir + slot * Kp + k0, In);
      st_chunk<LPT>(Dr + slot * Kp + k0, Dn);
      key_min(bv, bk);
      if (lane == 0) {
        xe[warp] = bv;
        xk[warp] = bk;
      }
      __syncthreads();
      float E = INF;
      int e_field = 0x7fffffff;
      if (lane < nw) {
        E = xe[lane];
        e_field = xk[lane];
      }
      key_min(E, e_field);
      park();

      // ---- B / T and the xnode word --------------------------------------
      float B = INF;
      int b_field = 1;
      consider(B, b_field, bn + xt[XT_NB], 1);
      consider(B, b_field, E + xt[XT_EB], 2);
      consider(B, b_field, bj + xt[XT_JB], 3);
      sb[slot] = B;
      if (warp == 0) {
        const float bc = cpos;
        float Tl = INF;
        int t_field = 0;
        consider(Tl, t_field, E + xt[XT_ET], 0);
        consider(Tl, t_field, bc + xt[XT_CT], 1);
        if (tid == 0)
          xnode[(size_t)sw * Lk + l - 1] = cwrd | (b_field << 4) |
                                           (e_field << 6) | (t_field << 25);
        sr[0][slot] = bn;
        sr[1][slot] = bj;
        sr[2][slot] = bc;
        sr[3][slot] = E;
      }
    }
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
  if (kTrellis && !scratch && Kp <= kPathFastMaxKp) {
    const int lpt = Kp <= kPathLpt2MaxKp ? 2 : 4;
    const size_t smem = (size_t)kPathFastPlanes * Kp * sizeof(float);
    auto kernel = lpt == 2 ? path_kernel<2> : path_kernel<4>;
    cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
    kernel<<<grid, Kp / lpt, smem, (cudaStream_t)stream>>>(
        (const int*)pidx, (const float*)tables, (const float*)tvecs,
        (const float*)xts, (const int*)lens, (const int*)starts,
        (const int*)codes, (int*)xnode, (int*)node, W, Kp, T, Lk);
    return (int)cudaGetLastError();
  }
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
