// Score kernels (B1, B3, B5, B8, B4, B4m, B9): null and alt min-plus
// costs of every scheduled window, the push/pending formulation of the
// frame Viterbi.  One DP body (`score_window`), seven entry points:
//
//   dtt_score_pairs          B1  `_kernel_pending` plain pairs form
//                                (`_scores_pairs_core`,
//                                `viterbi_scores_pairs_from_starts`);
//   dtt_score_mixed          B5  `_kernel_pending` mixed=True, one profile
//                                per slot (`_scores_pairs_mixed_vmem_core`);
//   dtt_score_chained        B3  `_kernel_pending` chain=True, C windows
//                                per slot (`_scores_pairs_chain_core`,
//                                `_chained_scores_jit`);
//   dtt_score_chained_carry  B8  `_kernel_pending` chain=True, carry=True,
//                                DP state across consecutive calls
//                                (`_scores_pairs_chain_carry_core`);
//   dtt_score_pairs_large    B4  `_kernel_block_large`, the large-K tier
//                                (`_scores_pairs_hbm_core`,
//                                `_gather_scores_pairs_hbm_jit`);
//   dtt_score_mixed_large    B4m `_kernel_block_large` mixed=True, one
//                                profile per slot: the gang of a scorer
//                                whose tables stream per wave
//                                (`_scores_pairs_hbm_core`,
//                                `_gather_scores_pairs_hbm_mixed_jit`);
//   dtt_score_grid           B9  `_kernel`, the pull-form score kernel of
//                                the dense grid (`_scores_grid_jit`,
//                                `viterbi_scores_grid`, `PallasScanEngine`)
//                                in every gather mode: every profile
//                                against every window.
//
// all in deciphon_tpu/ops/viterbi_pallas.py, with the `_ck_from_starts` /
// `_chain_expand` gathers fused: the body reads
// codes_all[min(start + l - 1, T - 1), t - 1] itself.  The reference clamps
// the gathered slice's offset instead (safe there only because of
// DeviceSeqCodes.TAIL_MARGIN); clamping each row reads the same rows for
// every real window.
//
// Mapping.  The TPU ran positions as a sequential grid axis with W windows
// on sublanes.  Here one CTA scans one real window, the position loop runs
// inside the block, and the Kp lanes are split into consecutive chunks, one
// per thread.  Up to Kp 2048, B1, B3, B5 and B8 run the redesigned body
// (score_window_fast): Kp / LPT threads of LPT lanes each (LPT 2 up to Kp
// 512, 4 beyond), the 5-slot pending rings PM/PI, the 8 transition rows
// and the staged emission rows of the next position in shared memory (23 *
// Kp f32: 188 KB at Kp 2048), the special states in warp 0, ring slots made
// static by unrolling the position loop into 5 phases (as the Pallas
// kernel does).  Past Kp 2048 (up to 5120) they run score_window, the
// first port's lane loop: the rings and the previous delete row in shared
// memory (11 * Kp f32), 512 threads, the specials in every thread.
//
// Large K (B4).  Past Kp 2048 a window's state (23 planes, 1.55 MB at Kp
// 16896) no longer fits one CTA's 227 KB, so B4 gives a window a thread-
// block cluster of c CTAs (up to 16, along x: grid (W * c, N)), each
// holding w lanes of every plane in its own shared memory and running the
// redesigned body on them; the hand-overs, the delete chain's carry and E
// cross CTAs through distributed shared memory on the body's two barrier
// rounds, now cluster barriers (see score_window_fast).  Up to Kp 2048 it
// is c = 1 and B4 launches B1's kernel.  The shape (c, w, LPT, threads,
// shared bytes) is ops/viterbi.py cluster_shape's, checked here, and a
// launch first asks cudaOccupancyMaxActiveClusters whether one such
// cluster can be resident (it must fit one GPC): if not it is refused.
// The TPU kernel launched once per 40-position block, gathered the
// block's emission planes with XLA and carried its state through HBM
// between launches, all because VMEM could not hold the table; here the
// body reads emission rows from the table in place and one launch runs
// every window to its length, with no state in global memory.
//
// B9 computes B1's function over a dense (profile x window) grid: the
// pull form's T and R equal the push form's bit for bit (rounding is
// monotone, so min(a, b) + e == min(a + e, b + e)), and the START-indexed
// code row of the fragment of length t ending at l is the row of the one
// starting at l - t + 1, which the push form reads.  So B9 is a grid
// instance of B4's body: one CTA a window up to Kp 2048, a cluster past
// it, in B4's launch shape, with no DP body and no state scratch of its
// own.
//
// B4m is B4 with B5's profile per slot: the TPU ran it when a gang's table
// stack did not fit VMEM or streamed in per wave.  On the card no table is
// on-chip, so a resident gang stays on B5 at any stack size; a streamed
// gang takes B4m as the reference's does.  Both compute B5's function, so
// B4m equals B5 bit for bit; up to Kp 2048 (c = 1) it launches B5's
// kernel.
//
// Chains (B3, B8).  The TPU chained windows back to back in one sublane
// slot only to fill its sublane floor; each window restarts from its own
// reseed at a block-aligned start (40 % 5 == 0), so its ring phases and f32
// operation order are those of the window scored alone.  A GPU has no such
// floor, so here every chain entry is its own CTA (grid (W * C, N)) and is
// scored from its own reseed: the same function as the chain, with C times
// the parallelism of running a slot's entries one after another in one CTA
// and no dependency between blocks.  Entries of length 0 (pads) write +inf
// and exit at once.  Carry (B8): a continuing entry (c == 0, w < CW,
// conts[n, w] > 0) loads the previous segment's exported state instead of
// the reseed, and entry c == 0 of every slot w < CW exports its final state
// in the reference's planes: big (13, CW, Kp) = PM[0:5] | PI[5:10] |
// ST[10:13] (ST = M, I, D of the last position: ring slots len % 5 and the
// delete row), small (32, CW) = PSM.reshape(20) | SS[20:27] | zeros[27:32].
//
// What bounds it.  Each position reads 5 emission rows of Kp f32 (from
// the (1364, Kp) table through L2) per window, far below L2 bandwidth, and
// does 34 adds and mins a lane; the kernel is bound by latency per
// position.  score_window spends it on six __syncthreads rounds (the
// shift, the prefix min and E, each block-wide reduction two rounds with a
// serial cross-warp loop), on codes and then emission rows loaded from
// global memory at the head of every position, and on transition rows
// re-read each position.  score_window_fast takes two rounds a position:
// the shift and the delete chain's cross-warp carry share the first (each
// warp's last lane hands its M on, and every warp rebuilds the first-lane
// terms and combines the warp scans with one warp-wide load and a shuffle
// scan), E's warp minima and the next position's inner hand-over share the
// second; the next position's emission rows are copied (cp.async) while
// the delete chain and E run, their codes fetched a position earlier; the
// special states are warp 0's, so the other warps skip them.  On one H100
// 80GB HBM3 (700.00 W), per position: B1 1.42 us at Kp 1024 (score_window
// 3.21) and 2.30 us at Kp 2048 (7.39); B3 1.43 us at Kp 1024 (3.16); B4
// on clusters 7.79 us at Kp 16512 (12 windows in two waves of 7 resident
// clusters; the global-state form 268), two cluster barriers taking 0.4-
// 0.7 us each of it; B9 on 8 x 8 pairs at K 16382 160.9 ms (B4 on the same
// pairs 160.5; the pull form it replaced, 2775).  Scores stay
// latency-bound: hundreds of times their operation bound (PERF.md).
//
// Exactness.  Min-plus uses only adds and mins, so the body keeps the
// Pallas f32 operation order: contrib = min(shift1(min(min(sm+MMs,
// si+IMs), sd+DMs)), B+BM); D = cummin(A - DDCUM) + DDCUM;
// R_l = PSM[3] + XT_RR with R_0 = -XT_RR.  Build without fast-math/ftz.
// The lane split does not enter the result, so B4 equals B1 bit for bit
// wherever both run.
#include "common.cuh"

namespace {

using namespace dtt;

constexpr int kScoreThreads = 512;
constexpr int kCW = 8;  // carry slots per pair (viterbi_pallas.CW)
constexpr int kStatePlanes = 11;  // PM (5) | PI (5) | Dv (1), Kp f32 each
// The redesigned body (score_window_fast) takes Kp up to kFastMaxKp, with
// LPT 2 lanes a thread up to kLpt2MaxKp and LPT 4 beyond (Kp / LPT
// threads); wider planes keep score_window's lane loop.
constexpr int kFastMaxKp = 2048;
constexpr int kLpt2MaxKp = 512;
// its shared planes: PM (5) | PI (5) | transition rows (8) | staged
// emission rows (5)
constexpr int kFastPlanes = 23;

// Carry planes of one (pair, slot): plane j of big at big + j * kCW * Kp,
// plane j of small at sml + j * kCW.
struct Carry {
  const float* big_in = nullptr;
  const float* sml_in = nullptr;
  float* big_out = nullptr;
  float* sml_out = nullptr;
};

// The first port's lane loop, kept for B1/B3/B5/B8 at 2048 < Kp <= 5120:
// the DP of one window, `len` positions of profile table/tv from code row
// `start`, (alt, null) written to *alt / *nul.  `state` holds the CTA's
// kStatePlanes * Kp f32 of shared memory.  Every thread of the CTA calls
// it; a length-0 window never gets here.
__device__ __forceinline__ void score_window(
    const float* __restrict__ table, const float* __restrict__ tv,
    const float* __restrict__ xtp, int start, int len,
    const int* __restrict__ codes, int Kp, int T, int lpt, float* state,
    Carry cy, float* alt, float* nul) {
  __shared__ float red[kMaxWarps];  // reduction scratch
  float* PM = state;          // [5][Kp] pending M
  float* PI = PM + 5 * Kp;    // [5][Kp] pending I
  float* Dv = PI + 5 * Kp;    // [Kp] previous D, then the pushed inner
  const float INF = inf_f();

  const float* tMMS = tv + TV_MMS * Kp;
  const float* tIMS = tv + TV_IMS * Kp;
  const float* tDMS = tv + TV_DMS * Kp;
  const float* tBM = tv + TV_BM * Kp;
  const float* tII = tv + TV_II * Kp;
  const float* tMI = tv + TV_MI * Kp;
  const float* tMD = tv + TV_MD * Kp;
  const float* tDDC = tv + TV_DDCUM * Kp;
  float xt[13];
#pragma unroll
  for (int j = 0; j < 13; ++j) xt[j] = xtp[j];
  const int k0 = min((int)threadIdx.x * lpt, Kp);
  const int k1 = min(k0 + lpt, Kp);
  const size_t cstride = (size_t)kCW * Kp;

  // specials of the previous position [S B N J C E R] and the pending
  // N/J/C/R rings, identical in every thread
  float ss[7];
  float psm[4][5];
  if (cy.big_in != nullptr) {  // continue a segmented window
    for (int k = threadIdx.x; k < Kp; k += blockDim.x) {
#pragma unroll
      for (int s = 0; s < 5; ++s) {
        PM[s * Kp + k] = cy.big_in[s * cstride + k];
        PI[s * Kp + k] = cy.big_in[(5 + s) * cstride + k];
      }
      Dv[k] = cy.big_in[12 * cstride + k];
    }
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 5; ++j) psm[i][j] = cy.sml_in[(i * 5 + j) * kCW];
#pragma unroll
    for (int j = 0; j < 7; ++j) ss[j] = cy.sml_in[(20 + j) * kCW];
  } else {
    for (int k = threadIdx.x; k < 5 * Kp; k += blockDim.x) {
      PM[k] = INF;
      PI[k] = INF;
    }
    for (int k = threadIdx.x; k < Kp; k += blockDim.x) Dv[k] = INF;
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 5; ++j) psm[i][j] = INF;
    ss[0] = 0.f;
    ss[1] = xt[XT_SB];
    ss[2] = ss[3] = ss[4] = ss[5] = INF;
    ss[6] = -xt[XT_RR];
  }
  __syncthreads();
  float Tfin = INF, Rfin = INF;

  for (int l0 = 0; l0 < len; l0 += 5) {
#pragma unroll
    for (int r = 0; r < 5; ++r) {
      const int l = l0 + r + 1;  // l % 5 == (r + 1) % 5
      if (l > len) break;
      // rows of the 5 fragments STARTING at position l
      const int crow = min(start + l - 1, T - 1);
      const float* er[5];
#pragma unroll
      for (int t = 0; t < 5; ++t)
        er[t] = table + (size_t)codes[(size_t)crow * 5 + t] * Kp;

      // -- inner = min(min(sm+MMs, si+IMs), sd+DMs) into Dv -------------
      const float* sm = PM + r * Kp;  // M_{l-1} sits in slot (l-1)%5 == r
      const float* si = PI + r * Kp;
      for (int k = k0; k < k1; ++k)
        Dv[k] = fminf(fminf(sm[k] + tMMS[k], si[k] + tIMS[k]),
                      Dv[k] + tDMS[k]);
      __syncthreads();

      // -- push the contributions of state l-1 -------------------------
      const float Bprev = ss[1];
      for (int k = k0; k < k1; ++k) {
        const int km = k == 0 ? Kp - 1 : k - 1;
        const float contrib = fminf(Dv[km], Bprev + tBM[k]);
        const float icand = fminf(si[k] + tII[k], sm[k] + tMI[k]);
#pragma unroll
        for (int t = 1; t <= 5; ++t) {
          const int st = (r + t) % 5;  // (l-1+t) % 5
          const float em = er[t - 1][k];
          const float bg = er[t - 1][Kp - 1];
          if (t == 5) {  // slot consumed at l-1: fresh assignment
            PM[st * Kp + k] = contrib + em;
            PI[st * Kp + k] = icand + bg;
          } else {
            PM[st * Kp + k] = fminf(PM[st * Kp + k], contrib + em);
            PI[st * Kp + k] = fminf(PI[st * Kp + k], icand + bg);
          }
        }
      }
      {
        const float cN = fminf(ss[0] + xt[XT_SN], ss[2] + xt[XT_NN]);
        const float cJ = fminf(ss[5] + xt[XT_EJ], ss[3] + xt[XT_JJ]);
        const float cC = fminf(ss[5] + xt[XT_EC], ss[4] + xt[XT_CC]);
        const float cR = ss[6];
#pragma unroll
        for (int t = 1; t <= 5; ++t) {
          const int st = (r + t) % 5;
          const float nil = er[t - 1][Kp - 2];
          if (t == 5) {
            psm[0][st] = cN + nil;
            psm[1][st] = cJ + nil;
            psm[2][st] = cC + nil;
            psm[3][st] = cR + nil;
          } else {
            psm[0][st] = fminf(psm[0][st], cN + nil);
            psm[1][st] = fminf(psm[1][st], cJ + nil);
            psm[2][st] = fminf(psm[2][st], cC + nil);
            psm[3][st] = fminf(psm[3][st], cR + nil);
          }
        }
      }
      __syncthreads();

      // -- consume position l ------------------------------------------
      const int slot = (r + 1) % 5;
      const float* Ml = PM + slot * Kp;
      float loc = INF;
      for (int k = k0; k < k1; ++k) {
        const int km = k == 0 ? Kp - 1 : k - 1;
        const float A = Ml[km] + tMD[k];
        loc = fminf(loc, A - tDDC[k]);
      }
      float run = block_excl_prefix_min(loc, red);
      float emin = INF;
      for (int k = k0; k < k1; ++k) {
        const int km = k == 0 ? Kp - 1 : k - 1;
        const float A = Ml[km] + tMD[k];
        run = fminf(run, A - tDDC[k]);
        const float D = run + tDDC[k];
        Dv[k] = D;
        emin = fminf(emin, fminf(Ml[k], D));
      }
      const float E = block_min(emin, red);
      const float N = psm[0][slot];
      const float J = psm[1][slot];
      const float C = psm[2][slot];
      const float R = psm[3][slot] + xt[XT_RR];
      const float B = fminf(fminf(N + xt[XT_NB], E + xt[XT_EB]),
                            J + xt[XT_JB]);
      const float Tl = fminf(E + xt[XT_ET], C + xt[XT_CT]);
      if (l == len) {
        Tfin = Tl;
        Rfin = R;
      }
      ss[0] = INF;
      ss[1] = B;
      ss[2] = N;
      ss[3] = J;
      ss[4] = C;
      ss[5] = E;
      ss[6] = R;
    }
  }
  if (threadIdx.x == 0) {
    *alt = Tfin;
    *nul = Rfin;
  }
  if (cy.big_out != nullptr) {
    // every thread exports the lanes it wrote; M_len and I_len are ring
    // slot len % 5, D_len is the delete row
    const int last = len % 5;
    for (int k = k0; k < k1; ++k) {
#pragma unroll
      for (int s = 0; s < 5; ++s) {
        cy.big_out[s * cstride + k] = PM[s * Kp + k];
        cy.big_out[(5 + s) * cstride + k] = PI[s * Kp + k];
      }
      cy.big_out[10 * cstride + k] = PM[last * Kp + k];
      cy.big_out[11 * cstride + k] = PI[last * Kp + k];
      cy.big_out[12 * cstride + k] = Dv[k];
    }
    if (threadIdx.x == 0) {
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 5; ++j) cy.sml_out[(i * 5 + j) * kCW] = psm[i][j];
#pragma unroll
      for (int j = 0; j < 7; ++j) cy.sml_out[(20 + j) * kCW] = ss[j];
      for (int j = 27; j < 32; ++j) cy.sml_out[j * kCW] = 0.f;
    }
  }
}

// The redesigned body of B1, B3, B5 and B8 (shared-memory state, Kp up to
// kFastMaxKp) and, clustered, of B4 and B4m: score_window's DP with
// blockDim.x * LPT == Kp (kClu false) or == w, this CTA's share of a
// cluster (kClu true; common.cuh).  Per position: the pushes (own lanes
// only); the next position's emission values fetched; the delete chain,
// whose warp scans, the M hand-over of each warp's last lane and lane
// Kp-1's wrap share one barrier (cross_warp_carry); then E and the next
// position's inner row, whose warp minima and inner hand-over share the
// second.  Neighbour lanes cross threads by shuffles inside a warp and
// through those two barriers between warps, so a thread touches only its
// own lanes of the rings.  The next position's emission rows are copied
// (cp.async) into a staging plane set on the own lanes right after the
// pushes (a thread stages and reads only its own lanes), their codes
// fetched a position earlier; the transition rows sit in shared memory
// beside the rings.  `state` holds kFastPlanes * (Kp or w) f32.
//
// Clustered, the two barriers are cluster barriers and values cross CTAs
// by DSMEM pushes made before them (common.cuh): a warp's first lane takes
// the M and inner row handed on by the previous warp, in the previous rank
// for warp 0 (lane Kp-1's, in the last rank, for rank 0), which the
// rank's last live lane pushes there.  The delete chain's carry into a
// warp is the min of the wrap term x_0 = (M_{Kp-1} + MD_0) - DDCUM_0 and of
// every earlier warp's term y, the min of its lanes' terms but its first
// and of the term of the lane after its last one (which it computes with
// the same f32 operations as the next lane's owner): that way the carry
// counts each lane's term up to the warp's own first lane, and counting
// that one twice changes no min.  A warp pushes y to its own rank and
// every later one, and its min of min(M, D) to every rank: E is the min
// over every warp of the cluster.  Every rank computes the specials
// identically; rank 0 writes alt and null.  Exchange slots: round 1 fills
// cly, cl1[0] and cl1[1], read only between the first and the second
// barrier; round 2 fills cle and cl1[2], read only between the second
// barrier and the next position's first; so a slot is rewritten only
// after every rank has passed the barrier that follows its reads.  Dead
// warps load nothing from global memory and push +inf; no live lane reads
// a dead one (the shift reads the left neighbour, and lane Kp-1 is live).
template <int LPT, bool kCarry, bool kClu>
__device__ __forceinline__ void score_window_fast(
    const float* __restrict__ table, const float* __restrict__ tv,
    const float* __restrict__ xtp, int start, int len,
    const int* __restrict__ codes, int Kp, int T, float* state, Carry cy,
    float* alt, float* nul) {
  static_assert(!(kCarry && kClu), "no carry on the clustered form");
  __shared__ float xs[kMaxWarps];      // warp scans, first lane left out
  __shared__ float xm[kMaxWarps + 1];  // M handed on by each warp's last lane
  __shared__ float xe[kMaxWarps];      // warp minima of min(M, D)
  __shared__ float xi[kMaxWarps + 1];  // next inner handed on likewise
  // clustered exchange arrays, filled by pushes: the warps' terms y
  // (round 1) and minima of min(M, D) (round 2) at [rank][warp]; the M
  // (0) and inner row (2) handed on to this rank's warp 0, and the wrap
  // term x_0 (1)
  __shared__ float cly[kClu ? kMaxCluster : 1][kMaxWarps];
  __shared__ float cle[kClu ? kMaxCluster : 1][kMaxWarps];
  __shared__ float cl1[3];
  __shared__ float xt[16];
  // The special states are warp 0's: its lanes compute them identically
  // and keep them here, the pending N/J/C/R rings and the specials of the
  // previous position [S B N J C E R]; before the first barrier it hands
  // N, J of the position to the other warps (njcr), which form B after
  // the second.
  __shared__ float sp[4][5], sst[7], njcr[2];
  const float INF = inf_f();
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int nw = blockDim.x >> 5;
  const int P = kClu ? (int)blockDim.x * LPT : Kp;  // lanes of a plane here
  const int rank = kClu ? cluster_rank() : 0;
  const int nc = kClu ? cluster_size() : 1;
  const int k0 = tid * LPT;      // first own lane in this CTA's planes
  const int kg = rank * P + k0;  // ... and in the window's
  const bool live = !kClu || rank * P + warp * 32 * LPT < Kp;
  const bool last = kg + LPT == Kp;  // owns lane Kp-1 (lane 0's neighbour)
  const int nb = warp == 0 ? kMaxWarps : warp - 1;  // hand-over slot
  // clustered: owns this rank's last live lane, whose M and inner row go
  // to the next rank's warp 0 (lane Kp-1's to rank 0)
  const bool ends =
      kClu && (last || (rank < nc - 1 && tid == (int)blockDim.x - 1));
  const int nxt = last ? 0 : rank + 1;
  float* PM = state;         // [5][P] pending M
  float* PI = PM + 5 * P;    // [5][P] pending I
  float* TVs = PI + 5 * P;   // [8][P] transition rows
  float* EMs = TVs + 8 * P;  // [5][P] emission rows of the next position
  const size_t cstride = (size_t)kCW * Kp;
  // the value handed on to this warp's first lane by the lane before it
  // (clustered warp 0: pushed into cl1[h])
  auto handed = [&](float* slots, int h) {
    if constexpr (kClu) {
      if (warp == 0) return cl1[h];
    }
    return slots[nb];
  };

  // transition rows of the own lanes
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
  auto row = [&](int q, float* v) { ld_chunk<LPT>(v, TVs + q * P + k0); };
  // MD and DDCUM: of warp `lane`'s first lane, for the cross-warp carry;
  // clustered, of the lane after this thread's last one (lane 0 after
  // lane Kp-1), for the term a warp's last lane publishes
  float md_w = INF, ddc_w = 0.f;
  if (kClu) {
    if (lane == 31 && live) {
      const int kn = last ? 0 : kg + LPT;
      md_w = __ldg(tv + TV_MD * Kp + kn);
      ddc_w = __ldg(tv + TV_DDCUM * Kp + kn);
    }
  } else if (lane < nw) {
    md_w = __ldg(tv + TV_MD * Kp + lane * 32 * LPT);
    ddc_w = __ldg(tv + TV_DDCUM * Kp + lane * 32 * LPT);
  }
  if (tid < 13) xt[tid] = xtp[tid];

  // B of the previous position (every thread); D of the previous
  // position on the own lanes
  float Bprev;
  float Dp[LPT];
  if (kCarry && cy.big_in != nullptr) {  // continue a segmented window
#pragma unroll
    for (int s = 0; s < 5; ++s) {
      float v[LPT];
      ldg_chunk<LPT>(v, cy.big_in + s * cstride + k0);
      st_chunk<LPT>(PM + s * P + k0, v);
      ldg_chunk<LPT>(v, cy.big_in + (5 + s) * cstride + k0);
      st_chunk<LPT>(PI + s * P + k0, v);
    }
    ldg_chunk<LPT>(Dp, cy.big_in + 12 * cstride + k0);
    if (warp == 0) {
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 5; ++j) sp[i][j] = cy.sml_in[(i * 5 + j) * kCW];
#pragma unroll
      for (int j = 0; j < 7; ++j) sst[j] = cy.sml_in[(20 + j) * kCW];
    }
    Bprev = cy.sml_in[21 * kCW];
  } else {
    float v[LPT];
#pragma unroll
    for (int j = 0; j < LPT; ++j) v[j] = Dp[j] = INF;
#pragma unroll
    for (int s = 0; s < 5; ++s) {
      st_chunk<LPT>(PM + s * P + k0, v);
      st_chunk<LPT>(PI + s * P + k0, v);
    }
    if (warp == 0) {
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 5; ++j) sp[i][j] = INF;
      sst[0] = 0.f;
      sst[1] = xtp[XT_SB];
      sst[2] = sst[3] = sst[4] = sst[5] = INF;
      sst[6] = -xtp[XT_RR];
    }
    Bprev = xtp[XT_SB];
  }
  // inner row of position 1 (M_0 and I_0 sit in ring slot 0) and its
  // hand-over
  float inn[LPT];
  {
    float Mp[LPT], Ip[LPT], mms[LPT], ims[LPT], dms[LPT];
    ld_chunk<LPT>(Mp, PM + k0);
    ld_chunk<LPT>(Ip, PI + k0);
    row(TV_MMS, mms);
    row(TV_IMS, ims);
    row(TV_DMS, dms);
#pragma unroll
    for (int j = 0; j < LPT; ++j)
      inn[j] = fminf(fminf(Mp[j] + mms[j], Ip[j] + ims[j]), Dp[j] + dms[j]);
  }
  float innb = __shfl_up_sync(kFull, inn[LPT - 1], 1);
  if (lane == 31) xi[warp] = inn[LPT - 1];
  if (last) xi[kMaxWarps] = inn[LPT - 1];
  if (kClu && tid == 0) cl1[2] = INF;  // no carry: the rows start at +inf

  // emission rows of position 1 (staged), codes of position 2
  // The next position's bg (lane Kp-1) values stay in registers; its nil
  // (lane Kp-2) values and the codes of the position after it are loaded
  // behind the first barrier and parked after the second in the warp's
  // own copy (every lane stores the same values).
  __shared__ float wst[kMaxWarps][15];
  float* ws = wst[warp];  // nil of duration t at 4 + t, codes at 9 + t
  float bgr[5], nlr[5];
  int cn[5];
  auto codes_of = [&](int l) {  // codes of the fragments starting at l
    const int crow = min(start + l - 1, T - 1);
#pragma unroll
    for (int t = 0; t < 5; ++t) cn[t] = __ldg(codes + (size_t)crow * 5 + t);
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
  if (lane == 0) innb = handed(xi, 2);

  for (int l0 = 0; l0 < len; l0 += 5) {
#pragma unroll
    for (int r = 0; r < 5; ++r) {
      const int l = l0 + r + 1;  // l % 5 == (r + 1) % 5
      if (l > len) break;

      // -- push the contributions of state l-1 (own lanes) -------------
      float Ml[LPT], Il[LPT];
      {
        float bm[LPT], ii[LPT], mi[LPT], contrib[LPT], icand[LPT];
        float Mp[LPT], Ip[LPT];  // M_{l-1} and I_{l-1}: ring slot r
        ld_chunk<LPT>(Mp, PM + r * P + k0);
        ld_chunk<LPT>(Ip, PI + r * P + k0);
        row(TV_BM, bm);
        row(TV_II, ii);
        row(TV_MI, mi);
#pragma unroll
        for (int j = 0; j < LPT; ++j) {
          contrib[j] = fminf(j == 0 ? innb : inn[j - 1], Bprev + bm[j]);
          icand[j] = fminf(Ip[j] + ii[j], Mp[j] + mi[j]);
        }
        cp_async_wait();  // this position's emission rows
#pragma unroll
        for (int t = 1; t <= 5; ++t) {
          const int st = (r + t) % 5;  // (l-1+t) % 5
          float* pm = PM + st * P + k0;
          float* pi = PI + st * P + k0;
          float em[LPT], vm[LPT], vi[LPT];
          ld_chunk<LPT>(em, EMs + (t - 1) * P + k0);
          if (t == 5) {  // slot consumed at l-1: fresh assignment
#pragma unroll
            for (int j = 0; j < LPT; ++j) {
              vm[j] = contrib[j] + em[j];
              vi[j] = icand[j] + bgr[4];
            }
          } else {
            ld_chunk<LPT>(vm, pm);
            ld_chunk<LPT>(vi, pi);
#pragma unroll
            for (int j = 0; j < LPT; ++j) {
              vm[j] = fminf(vm[j], contrib[j] + em[j]);
              vi[j] = fminf(vi[j], icand[j] + bgr[t - 1]);
            }
          }
          st_chunk<LPT>(pm, vm);
          st_chunk<LPT>(pi, vi);
          if (t == 1) {
#pragma unroll
            for (int j = 0; j < LPT; ++j) {
              Ml[j] = vm[j];
              Il[j] = vi[j];
            }
          }
        }
      }
      const int slot = (r + 1) % 5;
      if (warp == 0) {  // the pending specials, then N and J of l
        const float cN = fminf(sst[0] + xt[XT_SN], sst[2] + xt[XT_NN]);
        const float cJ = fminf(sst[5] + xt[XT_EJ], sst[3] + xt[XT_JJ]);
        const float cC = fminf(sst[5] + xt[XT_EC], sst[4] + xt[XT_CC]);
        const float cR = sst[6];
#pragma unroll
        for (int t = 1; t <= 5; ++t) {
          const int st = (r + t) % 5;
          const float nl = ws[4 + t];
          if (t == 5) {
            sp[0][st] = cN + nl;
            sp[1][st] = cJ + nl;
            sp[2][st] = cC + nl;
            sp[3][st] = cR + nl;
          } else {
            sp[0][st] = fminf(sp[0][st], cN + nl);
            sp[1][st] = fminf(sp[1][st], cJ + nl);
            sp[2][st] = fminf(sp[2][st], cC + nl);
            sp[3][st] = fminf(sp[3][st], cR + nl);
          }
        }
        njcr[0] = sp[0][slot];
        njcr[1] = sp[1][slot];
      }
      // this thread has read its lanes of this position's staged rows:
      // stage l+1's (a thread stages and reads only its own lanes), then
      // fetch the codes of l+2
#pragma unroll
      for (int t = 0; t < 5; ++t) cn[t] = __float_as_int(ws[10 + t]);
      fetch();
      codes_of(l + 2);

      // -- consume position l: the delete chain (barrier 1) ------------
      float md[LPT], ddc[LPT];
      row(TV_MD, md);
      row(TV_DDCUM, ddc);
      const float mb = __shfl_up_sync(kFull, Ml[LPT - 1], 1);
      float loc = INF;
#pragma unroll
      for (int j = 0; j < LPT; ++j) {
        if (j == 0 && lane == 0) continue;  // its neighbour is another warp's
        const float A = (j == 0 ? mb : Ml[j - 1]) + md[j];
        loc = fminf(loc, A - ddc[j]);
      }
      const float incl = warp_incl_min(loc);
      float run = __shfl_up_sync(kFull, incl, 1);
      if (kClu) {
        if (lane == 31) {
          // this warp's terms and the next lane's (lane 0's, the wrap,
          // after lane Kp-1), to this rank and every later one
          const float xn = (Ml[LPT - 1] + md_w) - ddc_w;
          const float y = !live ? INF : last ? incl : fminf(incl, xn);
          push(&cly[rank][warp], y, rank, nc);
          xm[warp] = Ml[LPT - 1];
          if (last) push(&cl1[1], xn, 0, nc);
          if (ends) *at_rank(&cl1[0], nxt) = Ml[LPT - 1];
        }
      } else if (lane == 31) {
        xs[warp] = incl;
        xm[warp] = Ml[LPT - 1];
      }
      if (last) xm[kMaxWarps] = Ml[LPT - 1];
      if (kClu) {
        cluster_sync();
        // every term before this warp's first lane: the earlier warps of
        // this rank, every warp of the earlier ranks, and the wrap
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
      const float N = njcr[0], J = njcr[1];
      const float nbm = lane == 0 ? handed(xm, 0) : mb;
      float emin = INF;
      {
        float mms[LPT], ims[LPT], dms[LPT];
        row(TV_MMS, mms);
        row(TV_IMS, ims);
        row(TV_DMS, dms);
#pragma unroll
        for (int j = 0; j < LPT; ++j) {
          const float A = (j == 0 ? nbm : Ml[j - 1]) + md[j];
          run = fminf(run, A - ddc[j]);
          const float D = run + ddc[j];
          emin = fminf(emin, fminf(Ml[j], D));
          inn[j] = fminf(fminf(Ml[j] + mms[j], Il[j] + ims[j]), D + dms[j]);
          if (kCarry) Dp[j] = D;
        }
        // the carry exports D_len: park it on the own lanes of the BM
        // plane, which nothing reads after the last position's pushes
        if (kCarry && l == len) st_chunk<LPT>(TVs + TV_BM * P + k0, Dp);
      }
      // -- E and the next inner hand-over (barrier 2) ------------------
      emin = warp_min(emin);
      const float ib = __shfl_up_sync(kFull, inn[LPT - 1], 1);
      if (kClu) {
        if (lane == 0) push(&cle[rank][warp], live ? emin : INF, 0, nc);
        if (ends) *at_rank(&cl1[2], nxt) = inn[LPT - 1];
      } else if (lane == 0) {
        xe[warp] = emin;
      }
      if (lane == 31) xi[warp] = inn[LPT - 1];
      if (last) xi[kMaxWarps] = inn[LPT - 1];
      float E;
      if (kClu) {
        cluster_sync();
        E = ranks_min(cle, nw, nc, INF);
      } else {
        __syncthreads();
        E = warp_min(lane < nw ? xe[lane] : INF);
      }
      innb = lane == 0 ? handed(xi, 2) : ib;
      park();

      const float B = fminf(fminf(N + xt[XT_NB], E + xt[XT_EB]),
                            J + xt[XT_JB]);
      Bprev = B;
      if (warp == 0) {
        const float C = sp[2][slot];
        const float R = sp[3][slot] + xt[XT_RR];
        if (l == len && tid == 0 && rank == 0) {
          *alt = fminf(E + xt[XT_ET], C + xt[XT_CT]);
          *nul = R;
        }
        sst[0] = INF;
        sst[1] = B;
        sst[2] = N;
        sst[3] = J;
        sst[4] = C;
        sst[5] = E;
        sst[6] = R;
      }
    }
  }
  // no CTA leaves while another may still read its shared memory
  if (kClu) cluster_sync();
  if (kCarry && cy.big_out != nullptr) {
    // every thread exports its lanes; M_len and I_len are ring slot
    // len % 5, D_len the last delete row
    const int lst = len % 5;
    float v[LPT];
#pragma unroll
    for (int s = 0; s < 5; ++s) {
      ld_chunk<LPT>(v, PM + s * P + k0);
      st_chunk<LPT>(cy.big_out + s * cstride + k0, v);
      if (s == lst) st_chunk<LPT>(cy.big_out + 10 * cstride + k0, v);
      ld_chunk<LPT>(v, PI + s * P + k0);
      st_chunk<LPT>(cy.big_out + (5 + s) * cstride + k0, v);
      if (s == lst) st_chunk<LPT>(cy.big_out + 11 * cstride + k0, v);
    }
    ld_chunk<LPT>(v, TVs + TV_BM * P + k0);  // D_len
    st_chunk<LPT>(cy.big_out + 12 * cstride + k0, v);
    if (threadIdx.x == 0) {
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 5; ++j) cy.sml_out[(i * 5 + j) * kCW] = sp[i][j];
#pragma unroll
      for (int j = 0; j < 7; ++j) cy.sml_out[(20 + j) * kCW] = sst[j];
      for (int j = 27; j < 32; ++j) cy.sml_out[j * kCW] = 0.f;
    }
  }
}

__device__ __forceinline__ void write_pad(float* alt, float* nul) {
  if (threadIdx.x == 0) {
    *alt = inf_f();
    *nul = inf_f();
  }
}

// B1 (kMixed false): blockIdx = (slot, pair), one profile per pair, pidx
// (N,).  B5: one profile per (pair, slot), pidx (N, W); the slot's
// transition rows are read in place (the reference gathers them per slot
// beforehand).  LPT > 0: the redesigned body at LPT lanes a thread; 0:
// score_window's lane loop at `lpt` lanes.
template <bool kMixed, int LPT>
__global__ void __launch_bounds__(kScoreThreads) score_pairs_kernel(
    const int* __restrict__ pidx, const float* __restrict__ tables,
    const float* __restrict__ tvecs, const float* __restrict__ xts,
    const int* __restrict__ lens, const int* __restrict__ starts,
    const int* __restrict__ codes, float* __restrict__ alt,
    float* __restrict__ nul, int W, int Kp, int T, int lpt) {
  const int n = blockIdx.y, w = blockIdx.x;
  const int sw = n * W + w;
  const int len = lens[sw];
  if (len <= 0) return write_pad(alt + sw, nul + sw);
  extern __shared__ float smem[];
  const int p = kMixed ? pidx[sw] : pidx[n];
  const float* table = tables + (size_t)p * kTableRows * Kp;
  const float* tv = tvecs + (size_t)p * 8 * Kp;
  if constexpr (LPT > 0)
    score_window_fast<LPT, false, false>(
        table, tv, xts + (size_t)sw * 16, starts[sw], len, codes, Kp, T, smem,
        Carry{}, alt + sw, nul + sw);
  else
    score_window(table, tv, xts + (size_t)sw * 16, starts[sw], len, codes,
                 Kp, T, lpt, smem, Carry{}, alt + sw, nul + sw);
}

// B4 (kMixed false) and B4m, clustered: blockIdx = (slot * c + rank, pair),
// one window a cluster of c CTAs, each holding its w lanes of the state
// in shared memory (kFastPlanes * w f32).  B4m reads pidx (N, W) and each
// slot's table and transition rows in place, as B5 does.  A window of
// length 0 leaves on every rank before the first cluster barrier (len is
// the same on every rank); rank 0 writes its +inf.
template <bool kMixed, int LPT>
__global__ void __launch_bounds__(kScoreThreads) score_large_kernel(
    const int* __restrict__ pidx, const float* __restrict__ tables,
    const float* __restrict__ tvecs, const float* __restrict__ xts,
    const int* __restrict__ lens, const int* __restrict__ starts,
    const int* __restrict__ codes, float* __restrict__ alt,
    float* __restrict__ nul, int W, int Kp, int T) {
  const int n = blockIdx.y, w = blockIdx.x / cluster_size();
  const int sw = n * W + w;
  const int len = lens[sw];
  if (len <= 0) {
    if (cluster_rank() == 0) write_pad(alt + sw, nul + sw);
    return;
  }
  extern __shared__ float smem[];
  const int p = kMixed ? pidx[sw] : pidx[n];
  score_window_fast<LPT, false, true>(
      tables + (size_t)p * kTableRows * Kp, tvecs + (size_t)p * 8 * Kp,
      xts + (size_t)sw * 16, starts[sw], len, codes, Kp, T, smem, Carry{},
      alt + sw, nul + sw);
}

// B9, the dense grid: blockIdx = (window * c + rank, profile), windows
// fastest, so that the CTAs resident at once share one profile's table in
// L2; one CTA a window up to Kp 2048 (kClu false, LPT 2 or 4) and a
// cluster of c CTAs past it.  The other order (profiles fastest: the
// CTAs of one window share its codes) took as long or longer on one H100
// 80GB HBM3 at 700.00 W, both orders in one call: 8 profiles x 128 windows
// of 4096 nt, 25.92 ms against 26.00 at K 400 and 35.03-35.33 against
// 35.18 at K 1000; 8 x 8 at K 16382, 160.84 against 161.67; 2 x 9 windows
// at Kp 5632, 1.90 against 1.98.  A window's xtrans row, length and code
// row are shared by every profile; the output is (profile, window).  A
// window of length 0 leaves on every rank before the first cluster
// barrier; rank 0 writes its +inf.
template <int LPT, bool kClu>
__global__ void __launch_bounds__(kScoreThreads) score_grid_kernel(
    const float* __restrict__ tables, const float* __restrict__ tvecs,
    const float* __restrict__ xts, const int* __restrict__ lens,
    const int* __restrict__ starts, const int* __restrict__ codes,
    float* __restrict__ alt, float* __restrict__ nul, int B, int Kp, int T) {
  const int p = blockIdx.y;
  const int w = kClu ? (int)blockIdx.x / cluster_size() : (int)blockIdx.x;
  const int o = p * B + w;
  const int len = lens[w];
  if (len <= 0) {
    if (!kClu || cluster_rank() == 0) write_pad(alt + o, nul + o);
    return;
  }
  extern __shared__ float smem[];
  score_window_fast<LPT, false, kClu>(
      tables + (size_t)p * kTableRows * Kp, tvecs + (size_t)p * 8 * Kp,
      xts + (size_t)w * 16, starts[w], len, codes, Kp, T, smem, Carry{},
      alt + o, nul + o);
}

// B3 (kCarry false) and B8: blockIdx = (slot * C + entry, pair); xtrans
// rows from the per-scan LUT.  B8 reads and writes the carry planes.
template <bool kCarry, int LPT>
__global__ void __launch_bounds__(kScoreThreads) score_chained_kernel(
    const int* __restrict__ pidx, const float* __restrict__ tables,
    const float* __restrict__ tvecs, const int* __restrict__ wlen,
    const int* __restrict__ gst, const int* __restrict__ xti,
    const float* __restrict__ lut, const int* __restrict__ codes,
    const int* __restrict__ conts, const float* __restrict__ cbig_in,
    const float* __restrict__ csml_in, float* __restrict__ cbig_out,
    float* __restrict__ csml_out, float* __restrict__ alt,
    float* __restrict__ nul, int W, int C, int Kp, int T, int lpt) {
  const int n = blockIdx.y;
  const int w = blockIdx.x / C, c = blockIdx.x % C;
  const int e = (n * W + w) * C + c;
  const int len = wlen[e];
  if (len <= 0) return write_pad(alt + e, nul + e);
  Carry cy;
  if (kCarry && c == 0 && w < kCW) {
    const size_t bo = ((size_t)n * 13 * kCW + w) * Kp;
    const size_t so = (size_t)n * 32 * kCW + w;
    if (conts[n * W + w] > 0) {
      cy.big_in = cbig_in + bo;
      cy.sml_in = csml_in + so;
    }
    cy.big_out = cbig_out + bo;
    cy.sml_out = csml_out + so;
  }
  extern __shared__ float smem[];
  const int p = pidx[n];
  const float* table = tables + (size_t)p * kTableRows * Kp;
  const float* tv = tvecs + (size_t)p * 8 * Kp;
  if constexpr (LPT > 0)
    score_window_fast<LPT, kCarry, false>(
        table, tv, lut + (size_t)xti[e] * 16, gst[e], len, codes, Kp, T, smem,
        cy, alt + e, nul + e);
  else
    score_window(table, tv, lut + (size_t)xti[e] * 16, gst[e], len, codes,
                 Kp, T, lpt, smem, cy, alt + e, nul + e);
}

// Lanes a thread of the redesigned body for lane width Kp; 0 past
// kFastMaxKp (score_window's lane loop).
int fast_lpt(int Kp) {
  return Kp > kFastMaxKp ? 0 : Kp <= kLpt2MaxKp ? 2 : 4;
}

// Launch shape of one instance: threads per CTA, lanes a thread and the
// dynamic shared memory (the DP state).
template <int LPT>
void shape(int Kp, int* threads, int* lpt, size_t* smem) {
  if constexpr (LPT > 0) {
    *threads = Kp / LPT;
    *lpt = LPT;
    *smem = (size_t)kFastPlanes * Kp * sizeof(float);
  } else {
    *threads = Kp < kScoreThreads ? Kp : kScoreThreads;
    *lpt = (Kp + *threads - 1) / *threads;
    *smem = (size_t)kStatePlanes * Kp * sizeof(float);
  }
}

}  // namespace

template <bool kMixed, int LPT>
static int go_pairs(const void* pidx, const void* tables, const void* tvecs,
                    const void* xts, const void* lens, const void* starts,
                    const void* codes, void* alt, void* nul, int N, int W,
                    int Kp, int T, void* stream) {
  int threads, lpt;
  size_t smem;
  shape<LPT>(Kp, &threads, &lpt, &smem);
  cudaError_t err = cudaFuncSetAttribute(
      score_pairs_kernel<kMixed, LPT>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  if (N > 0 && W > 0) {
    score_pairs_kernel<kMixed, LPT><<<dim3(W, N), threads, smem,
                                      (cudaStream_t)stream>>>(
        (const int*)pidx, (const float*)tables, (const float*)tvecs,
        (const float*)xts, (const int*)lens, (const int*)starts,
        (const int*)codes, (float*)alt, (float*)nul, W, Kp, T, lpt);
  }
  return (int)cudaGetLastError();
}

template <bool kMixed>
static int launch_pairs(const void* pidx, const void* tables,
                        const void* tvecs, const void* xts, const void* lens,
                        const void* starts, const void* codes, void* alt,
                        void* nul, int N, int W, int Kp, int T,
                        void* stream) {
  switch (fast_lpt(Kp)) {
    case 2:
      return go_pairs<kMixed, 2>(pidx, tables, tvecs, xts, lens, starts,
                                 codes, alt, nul, N, W, Kp, T, stream);
    case 4:
      return go_pairs<kMixed, 4>(pidx, tables, tvecs, xts, lens, starts,
                                 codes, alt, nul, N, W, Kp, T, stream);
    default:
      return go_pairs<kMixed, 0>(pidx, tables, tvecs, xts, lens, starts,
                                 codes, alt, nul, N, W, Kp, T, stream);
  }
}

// B1 and B5 share one signature; pidx is (N,) for B1 and (N, W) for B5.
extern "C" int dtt_score_pairs(
    const void* pidx, const void* tables, const void* tvecs, const void* xts,
    const void* lens, const void* starts, const void* codes, void* alt,
    void* nul, int N, int W, int Kp, int T, void* stream) {
  return launch_pairs<false>(pidx, tables, tvecs, xts, lens, starts, codes,
                             alt, nul, N, W, Kp, T, stream);
}

extern "C" int dtt_score_mixed(
    const void* pidx, const void* tables, const void* tvecs, const void* xts,
    const void* lens, const void* starts, const void* codes, void* alt,
    void* nul, int N, int W, int Kp, int T, void* stream) {
  return launch_pairs<true>(pidx, tables, tvecs, xts, lens, starts, codes,
                            alt, nul, N, W, Kp, T, stream);
}

template <bool kCarry, int LPT>
static int go_chained(const void* pidx, const void* tables,
                      const void* tvecs, const void* wlen, const void* gst,
                      const void* xti, const void* lut, const void* codes,
                      const void* conts, const void* cbig_in,
                      const void* csml_in, void* cbig_out, void* csml_out,
                      void* alt, void* nul, int N, int W, int C, int Kp,
                      int T, void* stream) {
  int threads, lpt;
  size_t smem;
  shape<LPT>(Kp, &threads, &lpt, &smem);
  cudaError_t err = cudaFuncSetAttribute(
      score_chained_kernel<kCarry, LPT>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  if (N > 0 && W > 0 && C > 0) {
    score_chained_kernel<kCarry, LPT><<<dim3(W * C, N), threads, smem,
                                        (cudaStream_t)stream>>>(
        (const int*)pidx, (const float*)tables, (const float*)tvecs,
        (const int*)wlen, (const int*)gst, (const int*)xti,
        (const float*)lut, (const int*)codes, (const int*)conts,
        (const float*)cbig_in, (const float*)csml_in, (float*)cbig_out,
        (float*)csml_out, (float*)alt, (float*)nul, W, C, Kp, T, lpt);
  }
  return (int)cudaGetLastError();
}

template <bool kCarry>
static int launch_chained(const void* pidx, const void* tables,
                          const void* tvecs, const void* wlen,
                          const void* gst, const void* xti, const void* lut,
                          const void* codes, const void* conts,
                          const void* cbig_in, const void* csml_in,
                          void* cbig_out, void* csml_out, void* alt,
                          void* nul, int N, int W, int C, int Kp, int T,
                          void* stream) {
  switch (fast_lpt(Kp)) {
    case 2:
      return go_chained<kCarry, 2>(pidx, tables, tvecs, wlen, gst, xti, lut,
                                   codes, conts, cbig_in, csml_in, cbig_out,
                                   csml_out, alt, nul, N, W, C, Kp, T,
                                   stream);
    case 4:
      return go_chained<kCarry, 4>(pidx, tables, tvecs, wlen, gst, xti, lut,
                                   codes, conts, cbig_in, csml_in, cbig_out,
                                   csml_out, alt, nul, N, W, C, Kp, T,
                                   stream);
    default:
      return go_chained<kCarry, 0>(pidx, tables, tvecs, wlen, gst, xti, lut,
                                   codes, conts, cbig_in, csml_in, cbig_out,
                                   csml_out, alt, nul, N, W, C, Kp, T,
                                   stream);
  }
}

extern "C" int dtt_score_chained(
    const void* pidx, const void* tables, const void* tvecs,
    const void* wlen, const void* gst, const void* xti, const void* lut,
    const void* codes, void* alt, void* nul, int N, int W, int C, int Kp,
    int T, void* stream) {
  return launch_chained<false>(pidx, tables, tvecs, wlen, gst, xti, lut,
                        codes, nullptr, nullptr, nullptr, nullptr, nullptr, alt,
                        nul, N, W, C, Kp, T, stream);
}

extern "C" int dtt_score_chained_carry(
    const void* pidx, const void* tables, const void* tvecs,
    const void* wlen, const void* gst, const void* xti, const void* lut,
    const void* codes, const void* conts, const void* cbig_in,
    const void* csml_in, void* cbig_out, void* csml_out, void* alt,
    void* nul, int N, int W, int C, int Kp, int T, void* stream) {
  return launch_chained<true>(pidx, tables, tvecs, wlen, gst, xti, lut,
                        codes, conts, cbig_in, csml_in, cbig_out, csml_out, alt,
                        nul, N, W, C, Kp, T, stream);
}

// B4 and B4m: the shape (c, w, lpt, threads, smem) comes from
// ops/viterbi.py cluster_shape; c = 1 runs B1's (B5's) kernel, c > 1 the
// clustered one.  *active gets the clusters that can be resident at once
// (left as it is when c = 1); a shape that cannot run is refused, never
// replaced.
template <bool kMixed>
static int launch_large(const void* pidx, const void* tables,
                        const void* tvecs, const void* xts, const void* lens,
                        const void* starts, const void* codes, void* alt,
                        void* nul, int N, int W, int Kp, int T, int c, int w,
                        int lpt, int threads, int smem, int* active,
                        void* stream) {
  if (c < 1 || c > kMaxCluster || threads * lpt != w || threads % 32 ||
      threads > kScoreThreads || (size_t)smem != (size_t)kFastPlanes * w * 4 ||
      (size_t)c * w < (size_t)Kp || (size_t)(c - 1) * w >= (size_t)Kp ||
      (c == 1 && lpt != fast_lpt(Kp)) || (c > 1 && lpt != 4))
    return (int)cudaErrorInvalidValue;
  if (c == 1)
    return lpt == 2 ? go_pairs<kMixed, 2>(pidx, tables, tvecs, xts, lens,
                                          starts, codes, alt, nul, N, W, Kp,
                                          T, stream)
                    : go_pairs<kMixed, 4>(pidx, tables, tvecs, xts, lens,
                                          starts, codes, alt, nul, N, W, Kp,
                                          T, stream);
  return dtt_launch_clusters(
      score_large_kernel<kMixed, 4>, dim3(W * c, N), c, threads, smem, stream,
      active, (const int*)pidx, (const float*)tables, (const float*)tvecs,
      (const float*)xts, (const int*)lens, (const int*)starts,
      (const int*)codes, (float*)alt, (float*)nul, W, Kp, T);
}

// pidx is (N,) for B4 and (N, W) for B4m.
extern "C" int dtt_score_pairs_large(
    const void* pidx, const void* tables, const void* tvecs, const void* xts,
    const void* lens, const void* starts, const void* codes, void* alt,
    void* nul, int N, int W, int Kp, int T, int c, int w, int lpt,
    int threads, int smem, int* active, void* stream) {
  return launch_large<false>(pidx, tables, tvecs, xts, lens, starts, codes,
                             alt, nul, N, W, Kp, T, c, w, lpt, threads, smem,
                             active, stream);
}

extern "C" int dtt_score_mixed_large(
    const void* pidx, const void* tables, const void* tvecs, const void* xts,
    const void* lens, const void* starts, const void* codes, void* alt,
    void* nul, int N, int W, int Kp, int T, int c, int w, int lpt,
    int threads, int smem, int* active, void* stream) {
  return launch_large<true>(pidx, tables, tvecs, xts, lens, starts, codes,
                            alt, nul, N, W, Kp, T, c, w, lpt, threads, smem,
                            active, stream);
}

// B9: P profiles against every one of B windows, the shape (c, w, lpt,
// threads, smem) ops/viterbi.py cluster_shape(Kp, "score")'s, checked as
// B4's is; c = 1 up to kFastMaxKp, clusters past it.
extern "C" int dtt_score_grid(
    const void* tables, const void* tvecs, const void* xts, const void* lens,
    const void* starts, const void* codes, void* alt, void* nul, int P,
    int B, int Kp, int T, int c, int w, int lpt, int threads, int smem,
    int* active, void* stream) {
  if (c < 1 || c > kMaxCluster || threads * lpt != w || threads % 32 ||
      threads > kScoreThreads || (size_t)smem != (size_t)kFastPlanes * w * 4 ||
      (size_t)c * w < (size_t)Kp || (size_t)(c - 1) * w >= (size_t)Kp ||
      (c == 1 && lpt != fast_lpt(Kp)) || (c > 1 && lpt != 4))
    return (int)cudaErrorInvalidValue;
  if (c > 1)
    return dtt_launch_clusters(
        score_grid_kernel<4, true>, dim3(B * c, P), c, threads, smem, stream,
        active, (const float*)tables, (const float*)tvecs, (const float*)xts,
        (const int*)lens, (const int*)starts, (const int*)codes, (float*)alt,
        (float*)nul, B, Kp, T);
  auto kernel = lpt == 2 ? score_grid_kernel<2, false>
                         : score_grid_kernel<4, false>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  if (P > 0 && B > 0)
    kernel<<<dim3(B, P), threads, smem, (cudaStream_t)stream>>>(
        (const float*)tables, (const float*)tvecs, (const float*)xts,
        (const int*)lens, (const int*)starts, (const int*)codes, (float*)alt,
        (float*)nul, B, Kp, T);
  return (int)cudaGetLastError();
}

extern "C" const char* dtt_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}
