// Score kernels (B1, B3, B5, B8, B4, B4m, B9): null and alt min-plus
// costs of every scheduled window, the push/pending formulation of the
// frame Viterbi.  One DP body (`score_window_fast`), five entry points
// for seven TPU kernels:
//
//   dtt_score_pairs          B1  `_kernel_pending` plain pairs form
//                                (`_scores_pairs_core`,
//                                `viterbi_scores_pairs_from_starts`), and
//                            B4  `_kernel_block_large`, the large-K tier
//                                (`_scores_pairs_hbm_core`,
//                                `_gather_scores_pairs_hbm_jit`);
//   dtt_score_mixed          B5  `_kernel_pending` mixed=True, one profile
//                                per slot (`_scores_pairs_mixed_vmem_core`),
//                                and
//                            B4m `_kernel_block_large` mixed=True, one
//                                profile per slot: the gang of a scorer
//                                whose tables stream per wave
//                                (`_scores_pairs_hbm_core`,
//                                `_gather_scores_pairs_hbm_mixed_jit`);
//   dtt_score_chained        B3  `_kernel_pending` chain=True, C windows
//                                per slot (`_scores_pairs_chain_core`,
//                                `_chained_scores_jit`);
//   dtt_score_chained_carry  B8  `_kernel_pending` chain=True, carry=True,
//                                DP state across consecutive calls
//                                (`_scores_pairs_chain_carry_core`);
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
// on sublanes.  Here one CTA, or one cluster of CTAs, scans one real
// window, the position loop runs inside the block, and the Kp lanes are
// split into consecutive chunks of LPT lanes, one per thread.  Up to Kp
// 2048 a window is one CTA of Kp / LPT threads (LPT 2 up to Kp 512, 4
// beyond) holding the 5-slot pending rings PM/PI, the 8 transition rows
// and the staged emission rows of the next position in shared memory (23 *
// Kp f32: 188 KB at Kp 2048), the special states in warp 0, ring slots made
// static by unrolling the position loop into 5 phases (as the Pallas
// kernel does).
//
// Clusters.  Past Kp 2048 a window's state (23 planes, 460 KB at Kp 5120,
// 1.55 MB at Kp 16896) no longer fits one CTA's 227 KB, so every entry
// point gives a window a thread-block cluster of c CTAs (up to 16, along
// x: grid (W * c, N), (W * C * c, N) for the chains), each holding w lanes
// of every plane in its own shared memory and running the same body on
// them; the hand-overs, the delete chain's carry and E cross CTAs through
// distributed shared memory on the body's two barrier rounds, now cluster
// barriers (see score_window_fast).  The shape (c, w, LPT, threads, shared
// bytes) is ops/viterbi.py cluster_shape's for every entry point, c = 1 up
// to Kp 2048, checked here (shape_ok), and a clustered launch first asks
// cudaOccupancyMaxActiveClusters whether one such cluster can be resident
// (it must fit one GPC): if not it is refused, never replaced.  At Kp
// 5120 that is 10 CTAs of 512 lanes, 128 threads and 47.1 KB each: the
// clustered instances hold 128 registers a thread, so the register file
// lets four such CTAs share an SM (two of 192 threads).  A window's 23
// planes leave fewer windows resident than an 11-plane body would, so up
// to Kp 2560 a full grid (264 windows) runs at 0.71-0.79x the first
// port's lane loop, and past it, or with few windows, 1.1-8.5x faster
// (PERF.md §6).  B4's TPU kernel launched once per 40-position block,
// gathered the block's emission planes with XLA and carried its state
// through HBM between launches, all because VMEM could not hold the table;
// here the body reads emission rows from the table in place and one launch
// runs every window to its length, with no state in global memory.
//
// B1 and B4 compute one function and share one entry point: B4 is the
// large-K tier's name for it past Kp 5120 (the scheduler's MAX_KP), B1
// the plain buckets' up to it.  B4m is B4 with B5's profile per slot: the
// TPU ran it when a gang's table stack did not fit VMEM or streamed in per
// wave.  On the card no table is on-chip, so a resident gang stays on B5
// at any stack size; a streamed gang takes B4m as the reference's does.
// Both compute B5's function and share B5's entry point, so B4m equals B5
// bit for bit.
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
// Chains (B3, B8).  The TPU chained windows back to back in one sublane
// slot only to fill its sublane floor; each window restarts from its own
// reseed at a block-aligned start (40 % 5 == 0), so its ring phases and f32
// operation order are those of the window scored alone.  A GPU has no such
// floor, so here every chain entry is its own CTA or cluster and is scored
// from its own reseed: the same function as the chain, with C times the
// parallelism of running a slot's entries one after another and no
// dependency between blocks.  Entries of length 0 (pads) write +inf and
// exit at once.  Carry (B8): a continuing entry (e == 0, w < CW,
// conts[n, w] > 0) loads the previous segment's exported state instead of
// the reseed, and entry e == 0 of every slot w < CW exports its final state
// in the reference's planes: big (13, CW, Kp) = PM[0:5] | PI[5:10] |
// ST[10:13] (ST = M, I, D of the last position: ring slots len % 5 and the
// delete row), small (32, CW) = PSM.reshape(20) | SS[20:27] | zeros[27:32].
// On a cluster each rank loads and exports the big planes' lanes it owns,
// every rank reads the small planes (warp 0 of every rank computes the
// specials) and rank 0 writes them.
//
// What bounds it.  Each position reads 5 emission rows of Kp f32 (from
// the (1364, Kp) table through L2) per window, far below L2 bandwidth, and
// does 34 adds and mins a lane; the kernel is bound by latency per
// position.  The body takes two barrier rounds a position: the shift and
// the delete chain's cross-warp carry share the first (each warp's last
// lane hands its M on, and every warp rebuilds the first-lane terms and
// combines the warp scans with one warp-wide load and a shuffle scan), E's
// warp minima and the next position's inner hand-over share the second;
// the next position's emission rows are copied (cp.async) while the
// delete chain and E run, their codes fetched a position earlier; the
// special states are warp 0's, so the other warps skip them.  On one H100
// 80GB HBM3 (700.00 W), per position: B1 1.42 us at Kp 1024 (the first
// port's lane loop 3.21) and 2.30 us at Kp 2048 (7.39); B3 1.43 us at Kp
// 1024 (3.16); B4 on clusters 7.79 us at Kp 16512 (12 windows in two waves
// of 7 resident clusters; the global-state form 268), two cluster barriers
// taking 0.4-0.7 us each of it; B9 on 8 x 8 pairs at K 16382 160.9 ms (B4
// on the same pairs 160.5; the pull form it replaced, 2775).  Scores stay
// latency-bound: hundreds of times their operation bound (PERF.md).
//
// Exactness.  Min-plus uses only adds and mins, so the body keeps the
// Pallas f32 operation order: contrib = min(shift1(min(min(sm+MMs,
// si+IMs), sd+DMs)), B+BM); D = cummin(A - DDCUM) + DDCUM;
// R_l = PSM[3] + XT_RR with R_0 = -XT_RR.  Build without fast-math/ftz.
// The lane split does not enter the result, so every instance equals the
// plain version, and B4 equals B1, bit for bit at every width.
#include "common.cuh"

namespace {

using namespace dtt;

constexpr int kScoreThreads = 512;
constexpr int kCW = 8;  // carry slots per pair (viterbi_pallas.CW)
// One CTA a window takes Kp up to kFastMaxKp, with LPT 2 lanes a thread up
// to kLpt2MaxKp and LPT 4 beyond (Kp / LPT threads); wider planes take a
// cluster of CTAs at LPT 4.
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

// The DP body of every score kernel: the window's state in shared memory,
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
//
// Carry on a cluster (B8): a rank loads and exports the big planes at its
// lanes' window index kg, its dead lanes +inf and never exported; the
// inner row of position 1 is then not +inf, so its hand-over into each
// rank's warp 0 is pushed into cl1[2] like every later position's, behind
// a cluster barrier of its own (no CTA's shared memory is written before
// every CTA of the cluster has started); the barrier before the position
// loop publishes it, and the next push into cl1[2] (position 1's second
// round) comes after every rank has read it.  Every rank reads the small
// planes; rank 0 writes them, with alt and null.
template <int LPT, bool kCarry, bool kClu>
__device__ __forceinline__ void score_window_fast(
    const float* __restrict__ table, const float* __restrict__ tv,
    const float* __restrict__ xtp, int start, int len,
    const int* __restrict__ codes, int Kp, int T, float* state, Carry cy,
    float* alt, float* nul) {
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
    // the planes at the own lanes' window index (dead lanes: +inf)
    auto load = [&](float* v, int plane) {
      if (live) {
        ldg_chunk<LPT>(v, cy.big_in + plane * cstride + kg);
      } else {
#pragma unroll
        for (int j = 0; j < LPT; ++j) v[j] = INF;
      }
    };
#pragma unroll
    for (int s = 0; s < 5; ++s) {
      float v[LPT];
      load(v, s);
      st_chunk<LPT>(PM + s * P + k0, v);
      load(v, 5 + s);
      st_chunk<LPT>(PI + s * P + k0, v);
    }
    load(Dp, 12);
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
  if constexpr (kClu && kCarry) {
    cluster_sync();  // every CTA of the cluster has started
    if (ends) *at_rank(&cl1[2], nxt) = inn[LPT - 1];
  } else if (kClu && tid == 0) {
    cl1[2] = INF;  // no carry: the rows start at +inf
  }

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
    // every live thread exports its lanes at their window index; M_len and
    // I_len are ring slot len % 5, D_len the last delete row
    const int lst = len % 5;
    float v[LPT];
    float* out = cy.big_out + kg;
    if (live) {
#pragma unroll
      for (int s = 0; s < 5; ++s) {
        ld_chunk<LPT>(v, PM + s * P + k0);
        st_chunk<LPT>(out + s * cstride, v);
        if (s == lst) st_chunk<LPT>(out + 10 * cstride, v);
        ld_chunk<LPT>(v, PI + s * P + k0);
        st_chunk<LPT>(out + (5 + s) * cstride, v);
        if (s == lst) st_chunk<LPT>(out + 11 * cstride, v);
      }
      ld_chunk<LPT>(v, TVs + TV_BM * P + k0);  // D_len
      st_chunk<LPT>(out + 12 * cstride, v);
    }
    if (tid == 0 && rank == 0) {
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
// beforehand).  One CTA a window (Kp up to kFastMaxKp), LPT lanes a
// thread.
template <bool kMixed, int LPT>
__global__ void __launch_bounds__(kScoreThreads) score_pairs_kernel(
    const int* __restrict__ pidx, const float* __restrict__ tables,
    const float* __restrict__ tvecs, const float* __restrict__ xts,
    const int* __restrict__ lens, const int* __restrict__ starts,
    const int* __restrict__ codes, float* __restrict__ alt,
    float* __restrict__ nul, int W, int Kp, int T) {
  const int n = blockIdx.y, w = blockIdx.x;
  const int sw = n * W + w;
  const int len = lens[sw];
  if (len <= 0) return write_pad(alt + sw, nul + sw);
  extern __shared__ float smem[];
  const int p = kMixed ? pidx[sw] : pidx[n];
  score_window_fast<LPT, false, false>(
      tables + (size_t)p * kTableRows * Kp, tvecs + (size_t)p * 8 * Kp,
      xts + (size_t)sw * 16, starts[sw], len, codes, Kp, T, smem, Carry{},
      alt + sw, nul + sw);
}

// B1 and B4 (kMixed false), B5 and B4m past kFastMaxKp, clustered:
// blockIdx = (slot * c + rank, pair), one window a cluster of c CTAs, each
// holding its w lanes of the state in shared memory (kFastPlanes * w f32).
// B5 and B4m read pidx (N, W) and each slot's table and transition rows in
// place.  A window of length 0 leaves on every rank before the first
// cluster barrier (len is the same on every rank); rank 0 writes its +inf.
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

// B3 (kCarry false) and B8: blockIdx = ((slot * C + entry) * c + rank,
// pair), one CTA an entry (kClu false, c = 1) up to Kp 2048, a cluster of
// c CTAs past it; xtrans rows from the per-scan LUT.  B8 reads and writes
// the carry planes (entry 0 of slots w < kCW).  A pad entry leaves on
// every rank before the first cluster barrier; rank 0 writes its +inf.
template <bool kCarry, int LPT, bool kClu>
__global__ void __launch_bounds__(kScoreThreads) score_chained_kernel(
    const int* __restrict__ pidx, const float* __restrict__ tables,
    const float* __restrict__ tvecs, const int* __restrict__ wlen,
    const int* __restrict__ gst, const int* __restrict__ xti,
    const float* __restrict__ lut, const int* __restrict__ codes,
    const int* __restrict__ conts, const float* __restrict__ cbig_in,
    const float* __restrict__ csml_in, float* __restrict__ cbig_out,
    float* __restrict__ csml_out, float* __restrict__ alt,
    float* __restrict__ nul, int W, int C, int Kp, int T) {
  const int n = blockIdx.y;
  const int we = kClu ? (int)blockIdx.x / cluster_size() : (int)blockIdx.x;
  const int w = we / C, c = we % C;
  const int e = (n * W + w) * C + c;
  const int len = wlen[e];
  if (len <= 0) {
    if (!kClu || cluster_rank() == 0) write_pad(alt + e, nul + e);
    return;
  }
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
  score_window_fast<LPT, kCarry, kClu>(
      tables + (size_t)p * kTableRows * Kp, tvecs + (size_t)p * 8 * Kp,
      lut + (size_t)xti[e] * 16, gst[e], len, codes, Kp, T, smem, cy,
      alt + e, nul + e);
}

// Whether (c, w, lpt, threads, smem), ops/viterbi.py cluster_shape(Kp)'s,
// is a shape the score body takes at lane width Kp: c ranks of w lanes
// (up to kMaxCluster), every rank holding live lanes, threads * lpt == w
// in whole warps within the kernels' thread bound, the body's shared
// planes, and LPT 2 up to kLpt2MaxKp, 4 beyond (and on every cluster).
// One CTA holds at most 512 * 4 = kFastMaxKp lanes, so c = 1 only there.
bool shape_ok(int Kp, int c, int w, int lpt, int threads, int smem) {
  return c >= 1 && c <= kMaxCluster && threads * lpt == w &&
         threads % 32 == 0 && threads <= kScoreThreads &&
         (size_t)smem == (size_t)kFastPlanes * w * 4 &&
         (size_t)c * w >= (size_t)Kp && (size_t)(c - 1) * w < (size_t)Kp &&
         lpt == (c == 1 && Kp <= kLpt2MaxKp ? 2 : 4);
}

// Launch `kernel` on `grid`, one CTA a window (c = 1), with `smem` bytes
// of dynamic shared memory.
template <typename... KArgs, typename... Args>
int launch_ctas(void (*kernel)(KArgs...), dim3 grid, int threads, int smem,
                void* stream, Args... args) {
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  if (grid.x > 0 && grid.y > 0)
    kernel<<<grid, threads, smem, (cudaStream_t)stream>>>(args...);
  return (int)cudaGetLastError();
}

}  // namespace

// B1/B4 and B5/B4m: the shape (c, w, lpt, threads, smem) comes from
// ops/viterbi.py cluster_shape; c = 1 runs one CTA a window, c > 1 a
// cluster a window.  *active gets the clusters that can be resident at
// once (left as it is when c = 1); a shape that cannot run is refused,
// never replaced.
template <bool kMixed>
static int launch_pairs(const void* pidx, const void* tables,
                        const void* tvecs, const void* xts, const void* lens,
                        const void* starts, const void* codes, void* alt,
                        void* nul, int N, int W, int Kp, int T, int c, int w,
                        int lpt, int threads, int smem, int* active,
                        void* stream) {
  if (!shape_ok(Kp, c, w, lpt, threads, smem))
    return (int)cudaErrorInvalidValue;
  const dim3 grid(W * c, N);
  if (c > 1)
    return dtt_launch_clusters(
        score_large_kernel<kMixed, 4>, grid, c, threads, smem, stream, active,
        (const int*)pidx, (const float*)tables, (const float*)tvecs,
        (const float*)xts, (const int*)lens, (const int*)starts,
        (const int*)codes, (float*)alt, (float*)nul, W, Kp, T);
  return launch_ctas(
      lpt == 2 ? score_pairs_kernel<kMixed, 2> : score_pairs_kernel<kMixed, 4>,
      grid, threads, smem, stream, (const int*)pidx, (const float*)tables,
      (const float*)tvecs, (const float*)xts, (const int*)lens,
      (const int*)starts, (const int*)codes, (float*)alt, (float*)nul, W, Kp,
      T);
}

// B1 and B4 (up to Kp 5120 and 16896) compute one function and launch
// through one entry point, B5 and B4m through the other; pidx is (N,) for
// B1 and B4, (N, W) for B5 and B4m.
extern "C" int dtt_score_pairs(
    const void* pidx, const void* tables, const void* tvecs, const void* xts,
    const void* lens, const void* starts, const void* codes, void* alt,
    void* nul, int N, int W, int Kp, int T, int c, int w, int lpt,
    int threads, int smem, int* active, void* stream) {
  return launch_pairs<false>(pidx, tables, tvecs, xts, lens, starts, codes,
                             alt, nul, N, W, Kp, T, c, w, lpt, threads, smem,
                             active, stream);
}

extern "C" int dtt_score_mixed(
    const void* pidx, const void* tables, const void* tvecs, const void* xts,
    const void* lens, const void* starts, const void* codes, void* alt,
    void* nul, int N, int W, int Kp, int T, int c, int w, int lpt,
    int threads, int smem, int* active, void* stream) {
  return launch_pairs<true>(pidx, tables, tvecs, xts, lens, starts, codes,
                            alt, nul, N, W, Kp, T, c, w, lpt, threads, smem,
                            active, stream);
}

// B3 and B8: the shape as for B1, c = 1 one CTA an entry, c > 1 a cluster
// an entry.
template <bool kCarry>
static int launch_chained(const void* pidx, const void* tables,
                          const void* tvecs, const void* wlen,
                          const void* gst, const void* xti, const void* lut,
                          const void* codes, const void* conts,
                          const void* cbig_in, const void* csml_in,
                          void* cbig_out, void* csml_out, void* alt,
                          void* nul, int N, int W, int C, int Kp, int T,
                          int c, int w, int lpt, int threads, int smem,
                          int* active, void* stream) {
  if (!shape_ok(Kp, c, w, lpt, threads, smem))
    return (int)cudaErrorInvalidValue;
  const dim3 grid(W * C * c, N);
  if (c > 1)
    return dtt_launch_clusters(
        score_chained_kernel<kCarry, 4, true>, grid, c, threads, smem, stream,
        active, (const int*)pidx, (const float*)tables, (const float*)tvecs,
        (const int*)wlen, (const int*)gst, (const int*)xti,
        (const float*)lut, (const int*)codes, (const int*)conts,
        (const float*)cbig_in, (const float*)csml_in, (float*)cbig_out,
        (float*)csml_out, (float*)alt, (float*)nul, W, C, Kp, T);
  return launch_ctas(
      lpt == 2 ? score_chained_kernel<kCarry, 2, false>
               : score_chained_kernel<kCarry, 4, false>,
      grid, threads, smem, stream, (const int*)pidx, (const float*)tables,
      (const float*)tvecs, (const int*)wlen, (const int*)gst,
      (const int*)xti, (const float*)lut, (const int*)codes,
      (const int*)conts, (const float*)cbig_in, (const float*)csml_in,
      (float*)cbig_out, (float*)csml_out, (float*)alt, (float*)nul, W, C, Kp,
      T);
}

extern "C" int dtt_score_chained(
    const void* pidx, const void* tables, const void* tvecs,
    const void* wlen, const void* gst, const void* xti, const void* lut,
    const void* codes, void* alt, void* nul, int N, int W, int C, int Kp,
    int T, int c, int w, int lpt, int threads, int smem, int* active,
    void* stream) {
  return launch_chained<false>(pidx, tables, tvecs, wlen, gst, xti, lut,
                               codes, nullptr, nullptr, nullptr, nullptr,
                               nullptr, alt, nul, N, W, C, Kp, T, c, w, lpt,
                               threads, smem, active, stream);
}

extern "C" int dtt_score_chained_carry(
    const void* pidx, const void* tables, const void* tvecs,
    const void* wlen, const void* gst, const void* xti, const void* lut,
    const void* codes, const void* conts, const void* cbig_in,
    const void* csml_in, void* cbig_out, void* csml_out, void* alt,
    void* nul, int N, int W, int C, int Kp, int T, int c, int w, int lpt,
    int threads, int smem, int* active, void* stream) {
  return launch_chained<true>(pidx, tables, tvecs, wlen, gst, xti, lut,
                              codes, conts, cbig_in, csml_in, cbig_out,
                              csml_out, alt, nul, N, W, C, Kp, T, c, w, lpt,
                              threads, smem, active, stream);
}

// B9: P profiles against every one of B windows, the shape (c, w, lpt,
// threads, smem) ops/viterbi.py cluster_shape(Kp, "score")'s, checked as
// B1's is; c = 1 up to kFastMaxKp, clusters past it.
extern "C" int dtt_score_grid(
    const void* tables, const void* tvecs, const void* xts, const void* lens,
    const void* starts, const void* codes, void* alt, void* nul, int P,
    int B, int Kp, int T, int c, int w, int lpt, int threads, int smem,
    int* active, void* stream) {
  if (!shape_ok(Kp, c, w, lpt, threads, smem))
    return (int)cudaErrorInvalidValue;
  const dim3 grid(B * c, P);
  if (c > 1)
    return dtt_launch_clusters(
        score_grid_kernel<4, true>, grid, c, threads, smem, stream, active,
        (const float*)tables, (const float*)tvecs, (const float*)xts,
        (const int*)lens, (const int*)starts, (const int*)codes, (float*)alt,
        (float*)nul, B, Kp, T);
  return launch_ctas(
      lpt == 2 ? score_grid_kernel<2, false> : score_grid_kernel<4, false>,
      grid, threads, smem, stream, (const float*)tables, (const float*)tvecs,
      (const float*)xts, (const int*)lens, (const int*)starts,
      (const int*)codes, (float*)alt, (float*)nul, B, Kp, T);
}

extern "C" const char* dtt_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}
