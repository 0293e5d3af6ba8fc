// Pull-form Viterbi kernel of phase 2 (B2): the packed backpointer
// trellis of every (pair, slot) window.
//
// B2 replaces deciphon_tpu/ops/viterbi_pallas.py `_kernel_path` (reached
// through `_paths_pairs_core` and `viterbi_paths_pairs`), with the
// `_ck_end_from_starts` gather fused: the END-indexed row of position l and
// duration t is codes_all[clamp(starts[n, w] + l - t, 0, T - 1), t - 1].
// (The dense-grid score kernel B9, `_kernel`, computes B1's function and
// runs the score body: viterbi_score.cu dtt_score_grid.)
//
// Mapping.  One real window per CTA up to Kp 2048 and per thread-block
// cluster of c CTAs past it (grid (W * c, N), c up to 16, each CTA holding
// w lanes of every plane; blockIdx = (slot * c + rank, pair), the profile
// pidx[pair]); the position loop inside the block, LPT consecutive lanes a
// thread; the M/I/D rings, the transition rows and the staged emission
// rows (28 planes) in shared memory, no state in global memory at any Kp;
// the N/J/C states in warp 0, with static ring slots from a 5-phase
// unrolled loop.  Output: xnode (N, W, Lk) and node (N, W, Lk, Kp) int32,
// row l-1 holding position l; rows at or past a window's length are not
// written (the walk never reads them), and positions past Lk are not run;
// length-0 slots exit at once.
//
// What bounds it.  Latency per position, plus the Kp int32 trellis row per
// position.  path_kernel takes two barrier rounds a position (the shift
// and the delete chain's cross-warp carry on the first, one reduction of
// the key (min(M, D), 2k + (M == min ? 0 : 1)) for E and its field on the
// second), copies the next position's emission rows (cp.async) ahead of
// the first round, keeps the transition rows in shared memory and makes
// 16-byte ring and trellis accesses; clustered, the rounds are cluster
// barriers and the per-warp values cross CTAs through distributed shared
// memory (path_kernel's note).  On one H100 80GB HBM3 (700.00 W), per
// position: 4.15 us at Kp 2048 and 2.75 us at Kp 1024, 6.48 us at Kp 5376
// on a cluster of 7 CTAs (the global-scratch form 41.5) (PERF.md).
//
// Exactness.  Candidate values are (state + trans) + emission in the
// reference's f32 order; t runs 5..1, then BM, MM, IM, DM and II, MI, with
// a strict `<` so the first minimum wins; field codes are choice*5 + t-1,
// initialised to the first candidate (bm 4, bi 9, n/j/c 4) so unreachable
// rows still match; e_field = 2*k_first + (1 - m_at_k) over all Kp lanes;
// D = cummin(A - DDCUM) + DDCUM and the D bit is D < A.  xnode bits:
// N(4@0) B(2@4) E(15@6) C(4@21) T(1@25) J(4@26); node: M(5@0) D(1@5) I(4@6).
// Built with -ftz=false -fmad=false (_build.py).
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

// The redesigned B2 (path_kernel) takes Kp up to kPathFastMaxKp in one CTA,
// LPT 2 lanes a thread up to kPathLpt2MaxKp and LPT 4 beyond (Kp / LPT
// threads, at most kPathFastThreads), and wider planes on a cluster of CTAs
// of at most kPathFastThreads threads at LPT 4.  Shared planes: M, I, D
// rings (15) | transition rows (8) | staged emission rows (5): 229,376
// bytes at Kp 2048.
constexpr int kPathFastMaxKp = 2048;
constexpr int kPathLpt2MaxKp = 1024;
constexpr int kPathFastThreads = 512;
constexpr int kPathFastPlanes = 28;
// a clustered CTA takes at most 384 threads (1536 lanes; ops/viterbi.py
// cluster_shape stays under it): 12 warps, 3 on each of an SM's four
// schedulers, which leaves a thread 168 registers (at 512 threads: 128,
// and the clustered instance spilled)
constexpr int kPathClusterThreads = 384;

// The redesigned B2 (rings in shared memory): blockDim.x * LPT == Kp (kClu
// false, Kp up to kPathFastMaxKp) or == w, this CTA's share of a cluster
// (kClu true, past it; common.cuh), a thread owning LPT consecutive
// lanes.  Per position: the M and I candidates of the own lanes, reading
// the ring slots on those lanes and the left neighbour lane with 16-byte
// accesses; the next position's emission rows copied (cp.async) into a
// staging plane set on the own lanes (a thread stages and reads only its
// own lanes), their codes fetched a position earlier; the delete chain,
// whose warp scans and M hand-overs share one barrier (cross_warp_carry);
// the trellis row stored, the rings written, and one reduction of the key
// (min(M, D), 2k + (M == min ? 0 : 1)), which gives E and the xnode E
// field together, on the second barrier.  Transition rows sit in shared
// memory beside the rings; the N/J/C states are warp 0's.
//
// Clustered, the two barriers are cluster barriers and values cross CTAs
// by pushes, as in score_window_fast: the delete chain's carry and M
// hand-over; the E key, reduced over every warp of the cluster (keys hold
// the window's lane, so a tie across a CTA boundary goes to the smaller
// lane); and thread 0's left neighbour, which lies in the previous rank
// (lane Kp-1, in the last rank, for rank 0): that rank's last live lane
// pushes its M, I and D of the position's ring slot into thread 0's halo
// (`hal`, beside the neighbour's transition values) before the second
// barrier, after the first, while thread 0 reads that slot's old values
// before the first.  Every rank runs the N/J/C states identically, rank
// 0 writes xnode and each rank its own lanes of node.  The exchange
// slots follow score_window_fast's rule.
template <int LPT, bool kClu>
__global__ void __launch_bounds__(kClu ? kPathClusterThreads
                                       : kPathFastThreads, 1) path_kernel(
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
  // clustered: the pushed exchange arrays (score_window_fast's cly, cl1;
  // the E keys' values and keys at [rank][warp]); thread 0's halo, M I D
  // of the left neighbour lane in ring slots 0-4 and its MMS, IMS, DMS
  __shared__ float cly[kClu ? kMaxCluster : 1][kMaxWarps];
  __shared__ float cle[kClu ? kMaxCluster : 1][kMaxWarps];
  __shared__ int clk[kClu ? kMaxCluster : 1][kMaxWarps];
  __shared__ float cl1[2], hal[kClu ? 18 : 1];
  // The N, J, C special states are warp 0's: its lanes compute them
  // identically and keep their rings [N J C E] here, with the position's
  // C and its xnode codes; before the first barrier it hands N and J of
  // the position to the other warps (nj), which form B after the second.
  __shared__ float sr[4][5], nj[2], cpos;
  __shared__ int cwrd;
  const int rank = kClu ? cluster_rank() : 0;
  const int nc = kClu ? cluster_size() : 1;
  const int n = blockIdx.y, w = kClu ? blockIdx.x / nc : blockIdx.x;
  const int sw = n * W + w;
  const int len = min(lens[sw], Lk);
  if (len <= 0) return;  // on every rank, before any cluster barrier
  const float INF = inf_f();
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int nw = blockDim.x >> 5;
  const int P = kClu ? (int)blockDim.x * LPT : Kp;  // lanes of a plane here
  const int k0 = tid * LPT;      // first own lane in this CTA's planes
  const int kg = rank * P + k0;  // ... and in the window's
  const bool live = !kClu || rank * P + warp * 32 * LPT < Kp;
  const bool last = kg + LPT == Kp;
  const int nb = warp == 0 ? kMaxWarps : warp - 1;  // hand-over slot
  const bool ends =  // see score_window_fast
      kClu && (last || (rank < nc - 1 && tid == (int)blockDim.x - 1));
  const int nxt = last ? 0 : rank + 1;
  float* Mr = smem;          // [5][P] M of positions l-5..l-1
  float* Ir = Mr + 5 * P;    // [5][P]
  float* Dr = Ir + 5 * P;    // [5][P]
  float* TVs = Dr + 5 * P;   // [8][P] transition rows
  float* EMs = TVs + 8 * P;  // [5][P] emission rows, duration t at t-1
  auto handed = [&](float* slots) {  // see score_window_fast
    if constexpr (kClu) {
      if (warp == 0) return cl1[0];
    }
    return slots[nb];
  };

  const int p = pidx[n];
  const float* table = tables + (size_t)p * kTableRows * Kp;
  const float* tv = tvecs + (size_t)p * 8 * Kp;
  for (int i = tid; i < 15 * P; i += blockDim.x) Mr[i] = INF;
#pragma unroll
  for (int q = 0; q < 8; ++q) {
    float v[LPT];
    if (live) {
      ldg_chunk<LPT>(v, tv + q * Kp + kg);
    } else {
#pragma unroll
      for (int j = 0; j < LPT; ++j) v[j] = INF;
    }
    st_chunk<LPT>(TVs + q * P + k0, v);
  }
  // MD and DDCUM of warp `lane`'s first lane, for the cross-warp carry;
  // clustered, of the lane after this thread's last (see score_window_fast)
  float md_w = INF, ddc_w = 0.f;
  if (kClu) {
    if (lane == 31 && live) {
      const int kn = last ? 0 : kg + LPT;
      md_w = __ldg(tv + TV_MD * Kp + kn);
      ddc_w = __ldg(tv + TV_DDCUM * Kp + kn);
    }
    if (tid == 0) {
      const int kn = rank == 0 ? Kp - 1 : kg - 1;
#pragma unroll
      for (int i = 0; i < 15; ++i) hal[i] = INF;
      hal[15] = __ldg(tv + TV_MMS * Kp + kn);
      hal[16] = __ldg(tv + TV_IMS * Kp + kn);
      hal[17] = __ldg(tv + TV_DMS * Kp + kn);
    }
  } else if (lane < nw) {
    md_w = __ldg(tv + TV_MD * Kp + lane * 32 * LPT);
    ddc_w = __ldg(tv + TV_DDCUM * Kp + lane * 32 * LPT);
  }
  if (tid < 13) xt[tid] = xts[(size_t)sw * 16 + tid];
  const int start = starts[sw];
  const bool halo = kClu && tid == 0;  // its left neighbour is the halo

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
      if (live) cp_chunk<LPT>(EMs + t * P + k0, er + kg);
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
  if (kClu)
    cluster_sync();  // also: every CTA of the cluster has started
  else
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
        // the left neighbour of the first own lane
        const int km0 = kClu ? max(k0 - 1, 0) : (k0 == 0 ? Kp - 1 : k0 - 1);
        float bmt[LPT], ii[LPT], mi[LPT];
        float mms[LPT + 1], ims[LPT + 1], dms[LPT + 1];  // lanes k0-1..
        ld_chunk<LPT>(bmt, TVs + TV_BM * P + k0);
        ld_chunk<LPT>(ii, TVs + TV_II * P + k0);
        ld_chunk<LPT>(mi, TVs + TV_MI * P + k0);
        if (halo) {
          mms[0] = hal[15];
          ims[0] = hal[16];
          dms[0] = hal[17];
        } else {
          mms[0] = TVs[TV_MMS * P + km0];
          ims[0] = TVs[TV_IMS * P + km0];
          dms[0] = TVs[TV_DMS * P + km0];
        }
        ld_chunk<LPT>(mms + 1, TVs + TV_MMS * P + k0);
        ld_chunk<LPT>(ims + 1, TVs + TV_IMS * P + k0);
        ld_chunk<LPT>(dms + 1, TVs + TV_DMS * P + k0);
#pragma unroll
        for (int j = 0; j < LPT; ++j) {
          Mn[j] = In[j] = INF;
          cd[j] = (0 * 5 + 4) | ((5 + 4) << 6);  // M code | I code << 6
        }
#pragma unroll
        for (int t = 5; t >= 1; --t) {
          const int s = (r + 1 - t + 10) % 5;  // (l - t + 10) % 5
          float Mx[LPT + 1], Ix[LPT + 1], Dx[LPT + 1];  // lanes k0-1..
          if (halo) {
            Mx[0] = hal[s];
            Ix[0] = hal[5 + s];
            Dx[0] = hal[10 + s];
          } else {
            Mx[0] = Mr[s * P + km0];
            Ix[0] = Ir[s * P + km0];
            Dx[0] = Dr[s * P + km0];
          }
          ld_chunk<LPT>(Mx + 1, Mr + s * P + k0);
          ld_chunk<LPT>(Ix + 1, Ir + s * P + k0);
          ld_chunk<LPT>(Dx + 1, Dr + s * P + k0);
          const float Bs = sb[s], bgt = bgr[t - 1];
          float em[LPT];
          ld_chunk<LPT>(em, EMs + (t - 1) * P + k0);
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
        int nc_ = 4, jc = 4, cc = 4;
#pragma unroll
        for (int t = 5; t >= 1; --t) {
          const int s = (r + 1 - t + 10) % 5;
          const float nl = ws[4 + t];
          const float S = (l0 == 0 && r + 1 == t) ? 0.f : INF;
          consider(bn, nc_, (S + xt[XT_SN]) + nl, 0 + (t - 1));
          consider(bn, nc_, (sr[0][s] + xt[XT_NN]) + nl, 5 + (t - 1));
          consider(bj, jc, (sr[3][s] + xt[XT_EJ]) + nl, 0 + (t - 1));
          consider(bj, jc, (sr[1][s] + xt[XT_JJ]) + nl, 5 + (t - 1));
          consider(bc, cc, (sr[3][s] + xt[XT_EC]) + nl, 0 + (t - 1));
          consider(bc, cc, (sr[2][s] + xt[XT_CC]) + nl, 5 + (t - 1));
        }
        nj[0] = bn;
        nj[1] = bj;
        cpos = bc;
        cwrd = nc_ | (cc << 21) | (jc << 26);
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
      ld_chunk<LPT>(md, TVs + TV_MD * P + k0);
      ld_chunk<LPT>(ddc, TVs + TV_DDCUM * P + k0);
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
      if (kClu) {
        if (lane == 31) {
          const float xn = (Mn[LPT - 1] + md_w) - ddc_w;
          const float y = !live ? INF : last ? incl : fminf(incl, xn);
          push(&cly[rank][warp], y, rank, nc);
          xm[warp] = Mn[LPT - 1];
          if (last) push(&cl1[1], xn, 0, nc);
          if (ends) *at_rank(&cl1[0], nxt) = Mn[LPT - 1];
        }
      } else if (lane == 31) {
        xs[warp] = incl;
        xm[warp] = Mn[LPT - 1];
      }
      if (last) xm[kMaxWarps] = Mn[LPT - 1];
      if (kClu) {
        cluster_sync();
        float bf = lane < warp ? cly[rank][lane] : INF;
        bf = ranks_min(cly, nw, rank, bf);
        bf = fminf(bf, cl1[1]);
        run = lane == 0 ? bf : fminf(bf, run);
      } else {
        __syncthreads();
        float xw;
        const float before = cross_warp_carry(xs, xm, md_w, ddc_w, &xw);
        run = lane == 0 ? before : fminf(fminf(before, xw), run);
      }
      const float bn = nj[0], bj = nj[1];
      const float nbm = lane == 0 ? handed(xm) : mb;

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
        const int key = 2 * (kg + j) + (Mn[j] == v ? 0 : 1);
        if (j == 0 || v < bv) {  // lanes ascend: the first minimum wins
          bv = v;
          bk = key;
        }
      }
      if (live) st_chunk<LPT>(node + ((size_t)sw * Lk + l - 1) * Kp + kg, nd);
      st_chunk<LPT>(Mr + slot * P + k0, Mn);
      st_chunk<LPT>(Ir + slot * P + k0, In);
      st_chunk<LPT>(Dr + slot * P + k0, Dn);
      key_min(bv, bk);
      if (kClu) {
        if (lane == 0) {
          push(&cle[rank][warp], live ? bv : INF, 0, nc);
          push(&clk[rank][warp], bk, 0, nc);
        }
        if (ends) {  // the next rank's thread 0: its left neighbour's slot
          float* h = at_rank(hal, nxt);
          h[slot] = Mn[LPT - 1];
          h[5 + slot] = In[LPT - 1];
          h[10 + slot] = Dn[LPT - 1];
        }
      } else if (lane == 0) {
        xe[warp] = bv;
        xk[warp] = bk;
      }
      float E = INF;
      int e_field = 0x7fffffff;
      if (kClu) {
        cluster_sync();
        ranks_key_min(cle, clk, nw, nc, E, e_field);
      } else {
        __syncthreads();
        if (lane < nw) {
          E = xe[lane];
          e_field = xk[lane];
        }
        key_min(E, e_field);
      }
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
        if (tid == 0 && rank == 0)
          xnode[(size_t)sw * Lk + l - 1] = cwrd | (b_field << 4) |
                                           (e_field << 6) | (t_field << 25);
        sr[0][slot] = bn;
        sr[1][slot] = bj;
        sr[2][slot] = bc;
        sr[3][slot] = E;
      }
    }
  }
  // no CTA leaves while another may still read its shared memory
  if (kClu) cluster_sync();
}

// B2: the shape (c, w, lpt, threads, smem) comes from ops/viterbi.py
// cluster_shape, checked here; c = 1 up to kPathFastMaxKp, clusters past
// it.  *active gets the clusters that can be resident at once (left as it
// is when c = 1); a shape that cannot run is refused, never replaced.
int launch_path(const void* pidx, const void* tables, const void* tvecs,
                const void* xts, const void* lens, const void* starts,
                const void* codes, void* xnode, void* node, int N, int W,
                int Kp, int T, int Lk, int c, int w, int lpt, int threads,
                int smem, int* active, void* stream) {
  const int band = Kp <= kPathLpt2MaxKp ? 2 : 4;
  if (c < 1 || c > kMaxCluster || threads * lpt != w || threads % 32 ||
      threads > kPathFastThreads ||
      (size_t)smem != (size_t)kPathFastPlanes * w * sizeof(float) ||
      (size_t)c * w < (size_t)Kp || (size_t)(c - 1) * w >= (size_t)Kp ||
      (c == 1 && (Kp > kPathFastMaxKp || lpt != band)) ||
      (c > 1 && (lpt != 4 || threads > kPathClusterThreads)))
    return (int)cudaErrorInvalidValue;
  if (c > 1)
    return dtt_launch_clusters(
        path_kernel<4, true>, dim3(W * c, N), c, threads, smem, stream,
        active, (const int*)pidx, (const float*)tables, (const float*)tvecs,
        (const float*)xts, (const int*)lens, (const int*)starts,
        (const int*)codes, (int*)xnode, (int*)node, W, Kp, T, Lk);
  auto kernel = lpt == 2 ? path_kernel<2, false> : path_kernel<4, false>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  if (N > 0 && W > 0)
    kernel<<<dim3(W, N), threads, smem, (cudaStream_t)stream>>>(
        (const int*)pidx, (const float*)tables, (const float*)tvecs,
        (const float*)xts, (const int*)lens, (const int*)starts,
        (const int*)codes, (int*)xnode, (int*)node, W, Kp, T, Lk);
  return (int)cudaGetLastError();
}

}  // namespace

// B2: N pairs of W slots, trellis of Lk rows per slot.
extern "C" int dtt_path_pairs(
    const void* pidx, const void* tables, const void* tvecs, const void* xts,
    const void* lens, const void* starts, const void* codes, void* xnode,
    void* node, int N, int W, int Kp, int T, int Lk, int c, int w, int lpt,
    int threads, int smem, int* active, void* stream) {
  return launch_path(pidx, tables, tvecs, xts, lens, starts, codes, xnode,
                     node, N, W, Kp, T, Lk, c, w, lpt, threads, smem, active,
                     stream);
}
