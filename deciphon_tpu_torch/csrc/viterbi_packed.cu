// Lane-packed phase-1 score kernels (B6, B7): S small profiles side by
// side on one plane of Kp = S * seg lanes, segment s on lanes
// [s * seg, (s + 1) * seg), every segment scanning a window of the same
// code stream.  Two entry points over one DP body
// (`score_window_packed_fast`):
//
//   dtt_score_packed          B6  `_kernel_pending_packed`
//                                 (`_scores_pairs_packed_core`,
//                                 `viterbi_scores_pairs_packed`): slot w's
//                                 window against all S profiles of a pack;
//   dtt_score_packed_chained  B7  `_kernel_pending_packed` chain=True
//                                 (`_scores_pairs_packed_chain_core`,
//                                 `viterbi_scores_pairs_packed_chained`):
//                                 a shared chain of code runs per slot, each
//                                 segment with its own window list laid
//                                 over it in chain block coordinates.
//
// all in deciphon_tpu/ops/viterbi_pallas.py.  The recurrence is
// `score_window_fast`'s (viterbi_score.cu) in the same f32 operation
// order; what packing changes is kept exactly as the reference has it:
//
//   * tables: a row of 2 * Kp + 128 floats = match costs per segment | the
//     owning segment's background cost replicated over its lanes | the
//     segments' null costs in columns 2 * Kp + s; the DD cumulative sum of
//     the transition vectors restarts per segment;
//   * the special states [S B N J C E R] and the pending N/J/C/R rings are
//     per segment;
//   * the delete-chain prefix min never crosses a segment boundary and E
//     is one minimum per segment;
//   * the lane shift is unmasked and wraps lane 0 to lane Kp - 1, as the
//     reference's: every profile has K + 1 <= seg, so the last lane of each
//     segment is a +inf pad and nothing finite crosses a boundary.  The
//     first lane of a segment takes M and the inner row from that pad lane
//     with the same f32 operations as any other lane.
//
// Mapping.  One CTA scans one slot's window (B6) or one chain entry index
// c of one slot (B7) for all S segments at once; the position loop runs in
// the block.  A thread owns LPT consecutive lanes (LPT 2 or 4, a template
// argument; Kp / LPT <= 512 threads, the shape is ops/viterbi.py
// `packed_shape`'s, checked again here).  seg is a multiple of 64, so a
// segment is a whole number of 16-thread groups at either LPT (a warp may
// hold two segments at LPT 4: seg 64, 192, 448 are 16, 48 and 112
// threads).  Shared memory as the score body's: the PM/PI rings, the 8
// transition rows and the staged emission rows of the next position, 23 *
// Kp f32 (188 KB at Kp 2048).
//
// Per position, two barrier rounds (the score body's; common.cuh):
//   1. the pushes on the own lanes, then the delete chain: each warp scans
//      its lane terms segment by segment (a shuffle scan flagged at the
//      segment's first thread), its last lane publishes its scan and hands
//      its M on; past the barrier every warp rebuilds the warps' first-lane
//      terms and combines the warp scans with one warp-wide load and a
//      segmented shuffle scan over warps, so a thread's carry comes only
//      from the earlier warps of its own segment;
//   2. E and the next inner row: each 16-thread group publishes its min of
//      min(M, D), and the next inner row's hand-over; past the barrier
//      every warp loads the group minima and reduces them by a segmented
//      shuffle scan over groups, each thread taking its segment's E.
//   Counting a term twice changes no min, so the carries are exact in any
//   grouping.
// The special states of all S segments live in warp 0: S <= 32 (seg >= 64
// and Kp <= 2048), and lane s owns segment s (its xtrans row, length,
// rings and [S N J C E R] in shared memory columns s).  Before the first
// barrier lane s publishes N and J of the position; every thread forms B
// of its own segment after the second, from the E it took, and lane s
// latches T and R at its segment's length.  Lane s also makes its
// segment's code rows (B7: a lookup in a table of the slot's runs in
// shared memory once every 40 positions), one position ahead: the codes of l + 2 are published between the two barriers of l,
// and every thread stages its own lanes of l + 1's emission rows by
// cp.async while the delete chain and E of l run, with the background cost
// of its segment (one column, the reference replicates it) in registers.
//
// Chains (B7).  Each window of each segment restarts from its own reseed at
// a block-aligned chain coordinate (40 % 5 == 0), so it is the same
// function as that window scored alone.  Entry c of every segment of a slot
// shares one CTA; each segment runs its own entry (start block, length,
// xtrans row), and the loop runs to the longest of them.  A window's code
// rows come from mapping its chain blocks back through the slot's run chain
// (the first run that covers the block; run 0's first block where none
// does, as `_chain_expand` leaves it).  The scheduler only emits lists that
// are equal across segments; lists that differ are taken all the same.
// Entries of length 0 (pads, idle segments) write +inf.
//
// What bounds it: as the score body, latency per position (two barrier
// rounds and the work between them), not bytes: 5 rows of 2 * Kp + 128
// floats per position through L2 (PERF.md has the times).
#include "common.cuh"

namespace {

using namespace dtt;

constexpr int kKappa = 40;  // positions per chain block (KAPPA_PENDING)
constexpr int kPackedThreads = 512;
constexpr int kPackedMaxKp = 2048;
// shared planes: PM (5) | PI (5) | transition rows (8) | staged emission
// rows (5)
constexpr int kPackedPlanes = 23;

// The slot's shared code stream: runs (start block, nt, first code row).
struct Runs {
  const int* sblk = nullptr;
  const int* len = nullptr;
  const int* gst = nullptr;
  int n = 0;
};

// Runs whose lookups read shared memory (the scheduler's chains hold at
// most 4).
constexpr int kSmemRuns = 32;

// First code row of chain block b: that of the first run that covers it,
// run 0's first row where none does.  `rt` holds the runs c < kSmemRuns as
// (first block, the block past the last (the first for a pad run), first
// code row); later runs are read from rn.
__device__ __forceinline__ int run_base(const Runs& rn,
                                        const int (*rt)[kSmemRuns], int b) {
  for (int c = 0; c < min(rn.n, kSmemRuns); ++c)
    if (rt[0][c] <= b && b < rt[1][c])
      return rt[2][c] + (b - rt[0][c]) * kKappa;
  for (int c = kSmemRuns; c < rn.n; ++c) {
    const int L = rn.len[c], b0 = rn.sblk[c];
    if (L > 0 && b0 <= b && b < b0 + (L + kKappa - 1) / kKappa)
      return rn.gst[c] + (b - b0) * kKappa;
  }
  return rt[2][0];
}

// What one segment of a CTA scans.
struct SegIn {
  const float* xt;  // its xtrans row
  int start;        // B6: its first code row; B7: its first chain block
  int len;          // its positions (0: idle)
  size_t out;       // its index in alt/nul
};

// The DP of one CTA: segment s scans seg_of(s) (SegIn), the loop runs to
// maxlen, the longest.  kChain: code rows through the run chain rn (B7);
// else from the segment's start row (B6).  `state` holds kPackedPlanes *
// Kp f32 of shared memory.
template <int LPT, bool kChain, typename SegOf>
__device__ __forceinline__ void score_window_packed_fast(
    const float* __restrict__ table, const float* __restrict__ tv,
    const int* __restrict__ codes, const Runs rn, SegOf seg_of, int maxlen,
    int Kp, int S, int T, float* state, float* alt, float* nul) {
  __shared__ float xs[kMaxWarps];      // warp scans, first lane left out
  __shared__ float xm[kMaxWarps + 1];  // M handed on by each warp's last lane
  __shared__ float xe[kMaxWarps];      // 16-thread groups' min of min(M, D)
  __shared__ float xi[kMaxWarps + 1];  // next inner handed on likewise
  // specials, column s for segment s (warp 0's lane s): the pending N/J/C/R
  // rings, [S N J C E R] of the previous position, the xtrans row; N and J
  // of the position for the other threads; code rows of the next fetch
  // (and of position 1)
  __shared__ float sp[4][5][kMaxWarps];
  __shared__ float sst[6][kMaxWarps];
  __shared__ float sxt[13][kMaxWarps];
  __shared__ float snj[2][kMaxWarps];
  __shared__ int scd[5][kMaxWarps];
  __shared__ int sc1[5][kMaxWarps];
  __shared__ int rt[3][kSmemRuns];  // the run table (B7)
  const float INF = inf_f();
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int nw = blockDim.x >> 5;
  const int ng = blockDim.x >> 4;  // 16-thread groups
  const int Wt = 2 * Kp + 128;
  const int seg = Kp / S;
  const int tps = seg / LPT;  // threads a segment
  const int m = tps >> 4;     // groups a segment
  const int k0 = tid * LPT;
  const int s = tid / tps;    // this thread's segment
  const int sf = s * tps;     // its first thread
  const int bgcol = Kp + s * seg;  // its background column
  const bool last = k0 + LPT == Kp;  // owns lane Kp-1 (lane 0's neighbour)
  const int nb = warp == 0 ? kMaxWarps : warp - 1;  // hand-over slot
  const bool spec = warp == 0 && lane < S;  // owns segment `lane`'s specials
  // lane i as warp i (the delete chain's carry): the first thread of the
  // segment that holds warp i's last thread, the first warp of that
  // segment, and whether warp i's first lane lies in it; lane j as group j
  // (E): the first group of its segment
  const int sfl = ((lane * 32 + 31) / tps) * tps;
  const int wfirst = sfl >> 5;
  const bool xin = lane * 32 >= sfl;
  const int gfirst = (lane / m) * m;
  const int glast = (s + 1) * m - 1;  // this thread's segment's last group
  float* PM = state;          // [5][Kp] pending M
  float* PI = PM + 5 * Kp;    // [5][Kp] pending I
  float* TVs = PI + 5 * Kp;   // [8][Kp] transition rows
  float* EMs = TVs + 8 * Kp;  // [5][Kp] emission rows of the next position

  // transition rows of the own lanes
#pragma unroll
  for (int q = 0; q < 8; ++q) {
    float v[LPT];
    ldg_chunk<LPT>(v, tv + q * Kp + k0);
    st_chunk<LPT>(TVs + q * Kp + k0, v);
  }
  auto row = [&](int q, float* v) { ld_chunk<LPT>(v, TVs + q * Kp + k0); };
  // MD and DDCUM of warp `lane`'s first lane, for the cross-warp carry
  float md_w = INF, ddc_w = 0.f;
  if (lane < nw) {
    md_w = __ldg(tv + TV_MD * Kp + lane * 32 * LPT);
    ddc_w = __ldg(tv + TV_DDCUM * Kp + lane * 32 * LPT);
  }
  // this thread's segment's xtrans values for B
  const float* xo = seg_of(s).xt;
  const float xNB = xo[XT_NB], xEB = xo[XT_EB], xJB = xo[XT_JB];
  float Bprev = xo[XT_SB];

  if constexpr (kChain) {  // the run table
    for (int c = tid; c < min(rn.n, kSmemRuns); c += blockDim.x) {
      const int L = rn.len[c];
      rt[0][c] = rn.sblk[c];
      rt[1][c] = L > 0 ? rn.sblk[c] + (L + kKappa - 1) / kKappa : rn.sblk[c];
      rt[2][c] = rn.gst[c];
    }
    __syncthreads();
  }

  // specials of segment `lane`: seeds, the +inf of an idle segment, and
  // its code rows: position p's row is base + off, off = (p - 1) % 40
  SegIn me{nullptr, 0, 0, 0};
  int off = 0, blk = 0, base = 0;
  int cs[5];    // codes of the next position to publish
  float nl[5];  // null costs of the position being pushed
  auto load_codes = [&]() {
    const int crow = min(max(base + off, 0), T - 1);
#pragma unroll
    for (int t = 0; t < 5; ++t) cs[t] = __ldg(codes + (size_t)crow * 5 + t);
  };
  auto advance = [&]() {
    if (++off == kKappa) {
      off = 0;
      ++blk;
      base = kChain ? run_base(rn, rt, blk) : base + kKappa;
    }
  };
  auto nulls = [&](float* v) {  // of the codes in cs
#pragma unroll
    for (int t = 0; t < 5; ++t)
      v[t] = __ldg(table + (size_t)cs[t] * Wt + 2 * Kp + lane);
  };
  if (spec) {
    me = seg_of(lane);
#pragma unroll
    for (int j = 0; j < 13; ++j) sxt[j][lane] = me.xt[j];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 5; ++j) sp[i][j][lane] = INF;
    sst[0][lane] = 0.f;
#pragma unroll
    for (int j = 1; j < 5; ++j) sst[j][lane] = INF;
    sst[5][lane] = -me.xt[XT_RR];
    if (me.len <= 0) {
      alt[me.out] = INF;
      nul[me.out] = INF;
    }
    blk = me.start;
    base = kChain ? run_base(rn, rt, blk) : me.start;
    load_codes();  // position 1
    nulls(nl);
#pragma unroll
    for (int t = 0; t < 5; ++t) sc1[t][lane] = cs[t];
    advance();
    load_codes();  // position 2
#pragma unroll
    for (int t = 0; t < 5; ++t) scd[t][lane] = cs[t];
  }

  // emission rows of the next position: staged by cp.async on the own
  // lanes (a thread stages and reads only its own lanes), the segment's
  // background cost of each fragment in registers
  float bgr[5];
  auto fetch = [&](const int (*cd)[kMaxWarps]) {
#pragma unroll
    for (int t = 0; t < 5; ++t) {
      const float* er = table + (size_t)cd[t][s] * Wt;
      cp_chunk<LPT>(EMs + t * Kp + k0, er + k0);
      bgr[t] = __ldg(er + bgcol);
    }
    cp_async_commit();
  };
  // inner row of position 1 (M_0, I_0 and D_0 are +inf) and its hand-over
  float inn[LPT];
  {
    float v[LPT], mms[LPT], ims[LPT], dms[LPT];
#pragma unroll
    for (int j = 0; j < LPT; ++j) v[j] = INF;
#pragma unroll
    for (int q = 0; q < 5; ++q) {
      st_chunk<LPT>(PM + q * Kp + k0, v);
      st_chunk<LPT>(PI + q * Kp + k0, v);
    }
    row(TV_MMS, mms);
    row(TV_IMS, ims);
    row(TV_DMS, dms);
#pragma unroll
    for (int j = 0; j < LPT; ++j)
      inn[j] = fminf(fminf(v[j] + mms[j], v[j] + ims[j]), v[j] + dms[j]);
  }
  float innb = __shfl_up_sync(kFull, inn[LPT - 1], 1);
  if (lane == 31) xi[warp] = inn[LPT - 1];
  if (last) xi[kMaxWarps] = inn[LPT - 1];
  __syncthreads();  // sc1, scd, the specials' seeds and the hand-over
  if (lane == 0) innb = xi[nb];
  fetch(sc1);  // sc1 is not written again

  for (int l0 = 0; l0 < maxlen; l0 += 5) {
#pragma unroll
    for (int r = 0; r < 5; ++r) {
      const int l = l0 + r + 1;  // l % 5 == (r + 1) % 5
      if (l > maxlen) break;

      // -- push the contributions of state l-1 (own lanes) -------------
      float Ml[LPT], Il[LPT];
      {
        float bm[LPT], ii[LPT], mi[LPT], contrib[LPT], icand[LPT];
        float Mp[LPT], Ip[LPT];  // M_{l-1} and I_{l-1}: ring slot r
        ld_chunk<LPT>(Mp, PM + r * Kp + k0);
        ld_chunk<LPT>(Ip, PI + r * Kp + k0);
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
          float* pm = PM + st * Kp + k0;
          float* pi = PI + st * Kp + k0;
          float em[LPT], vm[LPT], vi[LPT];
          ld_chunk<LPT>(em, EMs + (t - 1) * Kp + k0);
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
      float nln[5];
      if (spec) {  // the pending specials, then N and J of l
        const float cN = fminf(sst[0][lane] + sxt[XT_SN][lane],
                               sst[1][lane] + sxt[XT_NN][lane]);
        const float cJ = fminf(sst[4][lane] + sxt[XT_EJ][lane],
                               sst[2][lane] + sxt[XT_JJ][lane]);
        const float cC = fminf(sst[4][lane] + sxt[XT_EC][lane],
                               sst[3][lane] + sxt[XT_CC][lane]);
        const float cR = sst[5][lane];
#pragma unroll
        for (int t = 1; t <= 5; ++t) {
          const int st = (r + t) % 5;
          const float v = nl[t - 1];
          if (t == 5) {
            sp[0][st][lane] = cN + v;
            sp[1][st][lane] = cJ + v;
            sp[2][st][lane] = cC + v;
            sp[3][st][lane] = cR + v;
          } else {
            sp[0][st][lane] = fminf(sp[0][st][lane], cN + v);
            sp[1][st][lane] = fminf(sp[1][st][lane], cJ + v);
            sp[2][st][lane] = fminf(sp[2][st][lane], cC + v);
            sp[3][st][lane] = fminf(sp[3][st][lane], cR + v);
          }
        }
        snj[0][lane] = sp[0][slot][lane];
        snj[1][lane] = sp[1][slot][lane];
        // null costs of l+1 (cs holds its codes), then the codes of l+2
        nulls(nln);
        advance();
        load_codes();
      }
      // this thread has read its lanes of this position's staged rows:
      // stage l+1's
      fetch(scd);

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
      // the warp's scan, segment by segment
      const float incl = warp_seg_incl_min(loc, tid, sf);
      const float prev = __shfl_up_sync(kFull, incl, 1);
      if (lane == 31) {
        xs[warp] = incl;
        xm[warp] = Ml[LPT - 1];
      }
      if (last) xm[kMaxWarps] = Ml[LPT - 1];
      __syncthreads();
      const float N = snj[0][s], J = snj[1][s];
      // lane i: warp i's first-lane term and the scan of warps i' <= i of
      // the segment that holds warp i's last thread
      float run;
      {
        float x = INF, f = INF;
        if (lane < nw) {
          x = (xm[lane == 0 ? kMaxWarps : lane - 1] + md_w) - ddc_w;
          f = fminf(xs[lane], xin ? x : INF);
        }
        f = warp_seg_incl_min(f, lane, wfirst);
        const float xw = __shfl_sync(kFull, x, warp);
        const float fw = __shfl_sync(kFull, f, warp > 0 ? warp - 1 : 0);
        // terms of the earlier warps of this segment, and this warp's
        // first-lane term where that lane lies in the segment
        const float carry = warp * 32 > sf ? fw : INF;
        if (lane == 0)
          run = carry;
        else if (tid > sf)
          run = fminf(fminf(carry, warp * 32 >= sf ? xw : INF), prev);
        else  // the segment's first thread
          run = INF;
      }
      const float nbm = lane == 0 ? xm[nb] : mb;
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
        }
      }
      // -- E and the next inner hand-over (barrier 2) ------------------
#pragma unroll
      for (int o = 8; o > 0; o >>= 1)
        emin = fminf(emin, __shfl_xor_sync(kFull, emin, o));
      if ((lane & 15) == 0) xe[tid >> 4] = emin;
      const float ib = __shfl_up_sync(kFull, inn[LPT - 1], 1);
      if (lane == 31) xi[warp] = inn[LPT - 1];
      if (last) xi[kMaxWarps] = inn[LPT - 1];
      if (spec) {
#pragma unroll
        for (int t = 0; t < 5; ++t) scd[t][lane] = cs[t];
      }
      __syncthreads();
      const float e = warp_seg_incl_min(lane < ng ? xe[lane] : INF, lane,
                                        gfirst);
      const float E = __shfl_sync(kFull, e, glast);
      innb = lane == 0 ? xi[nb] : ib;
      Bprev = fminf(fminf(N + xNB, E + xEB), J + xJB);
      if (warp == 0) {
        const float Es = __shfl_sync(kFull, e, min((lane + 1) * m - 1, 31));
        if (spec) {
          const float C = sp[2][slot][lane];
          const float R = sp[3][slot][lane] + sxt[XT_RR][lane];
          if (l == me.len) {
            alt[me.out] = fminf(Es + sxt[XT_ET][lane], C + sxt[XT_CT][lane]);
            nul[me.out] = R;
          }
          sst[0][lane] = INF;
          sst[1][lane] = snj[0][lane];
          sst[2][lane] = snj[1][lane];
          sst[3][lane] = C;
          sst[4][lane] = Es;
          sst[5][lane] = R;
#pragma unroll
          for (int t = 0; t < 5; ++t) nl[t] = nln[t];
        }
      }
    }
  }
  cp_async_wait();  // the last position's unused staging
}

// B6: blockIdx = (slot, pair); alt/nul (N, W, S).
template <int LPT>
__global__ void __launch_bounds__(kPackedThreads) score_packed_kernel(
    const int* __restrict__ pidx, const float* __restrict__ tables,
    const float* __restrict__ tvecs, const float* __restrict__ xts,
    const int* __restrict__ lens, const int* __restrict__ starts,
    const int* __restrict__ codes, float* __restrict__ alt,
    float* __restrict__ nul, int W, int S, int Kp, int T) {
  const int n = blockIdx.y, w = blockIdx.x;
  const int sw = n * W + w;
  const int len = lens[sw];
  if (len <= 0) {
    if ((int)threadIdx.x < S) {
      alt[(size_t)sw * S + threadIdx.x] = inf_f();
      nul[(size_t)sw * S + threadIdx.x] = inf_f();
    }
    return;
  }
  extern __shared__ float smem[];
  const int p = pidx[n];
  const float* xt = xts + (size_t)sw * 16;
  const int start = starts[sw];
  score_window_packed_fast<LPT, false>(
      tables + (size_t)p * kTableRows * (2 * Kp + 128),
      tvecs + (size_t)p * 8 * Kp, codes, Runs{},
      [&](int s) { return SegIn{xt, start, len, (size_t)sw * S + s}; }, len,
      Kp, S, T, smem, alt, nul);
}

// B7: blockIdx = (slot * C + entry, pair); run_* (N, W, CR), win_*
// (N, W, S, C), alt/nul (N, W, S, C).
template <int LPT>
__global__ void __launch_bounds__(kPackedThreads) score_packed_chained_kernel(
    const int* __restrict__ pidx, const float* __restrict__ tables,
    const float* __restrict__ tvecs, const int* __restrict__ run_sblk,
    const int* __restrict__ run_len, const int* __restrict__ run_gst,
    const int* __restrict__ win_sblk, const int* __restrict__ win_len,
    const int* __restrict__ win_xti, const float* __restrict__ lut,
    const int* __restrict__ codes, float* __restrict__ alt,
    float* __restrict__ nul, int W, int S, int C, int CR, int Kp, int T) {
  const int n = blockIdx.y;
  const int w = blockIdx.x / C, c = blockIdx.x % C;
  const size_t sw = (size_t)n * W + w;
  const int lane = threadIdx.x & 31;
  // the longest entry of the segments (every warp reduces it itself)
  int maxlen = lane < S ? win_len[(sw * S + lane) * C + c] : 0;
#pragma unroll
  for (int o = 16; o > 0; o >>= 1)
    maxlen = max(maxlen, __shfl_xor_sync(kFull, maxlen, o));
  if (maxlen <= 0) {
    if ((int)threadIdx.x < S) {
      alt[(sw * S + threadIdx.x) * C + c] = inf_f();
      nul[(sw * S + threadIdx.x) * C + c] = inf_f();
    }
    return;
  }
  extern __shared__ float smem[];
  Runs rn;
  rn.sblk = run_sblk + sw * CR;
  rn.len = run_len + sw * CR;
  rn.gst = run_gst + sw * CR;
  rn.n = CR;
  const int p = pidx[n];
  score_window_packed_fast<LPT, true>(
      tables + (size_t)p * kTableRows * (2 * Kp + 128),
      tvecs + (size_t)p * 8 * Kp, codes, rn,
      [&](int s) {
        const size_t e = (sw * S + s) * C + c;
        return SegIn{lut + (size_t)win_xti[e] * 16, win_sblk[e],
                     max(win_len[e], 0), e};
      },
      maxlen, Kp, S, T, smem, alt, nul);
}

// cudaErrorInvalidValue unless the plane and the launch shape are ones the
// kernels take (ops/viterbi.py packed_shape): Kp a multiple of 128 up to
// 2048 in S <= 32 segments of a multiple of 64 lanes, LPT 2 or 4, Kp / LPT
// threads (whole warps, at most kPackedThreads), each segment a whole
// number of 16-thread groups, kPackedPlanes * Kp f32 of shared memory.
bool packed_shape_ok(int S, int Kp, int lpt, int threads, int smem) {
  if (S <= 0 || S > kMaxWarps || Kp <= 0 || Kp > kPackedMaxKp ||
      Kp % 128 || Kp % S || (Kp / S) % 64)
    return false;
  if ((lpt != 2 && lpt != 4) || threads * lpt != Kp || threads % 32 ||
      threads > kPackedThreads || (Kp / S / lpt) % 16)
    return false;
  return (size_t)smem == (size_t)kPackedPlanes * Kp * sizeof(float);
}

// Set the kernel's shared memory and, when `active` is given, store the
// CTAs of this shape that one SM holds at once.
template <typename K>
cudaError_t prepare(K kernel, int threads, int smem, int* active) {
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err == cudaSuccess && active != nullptr)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(active, kernel,
                                                        threads, smem);
  return err;
}

template <int LPT>
int go_packed(const void* pidx, const void* tables, const void* tvecs,
              const void* xts, const void* lens, const void* starts,
              const void* codes, void* alt, void* nul, int N, int W, int S,
              int Kp, int T, int threads, int smem, int* active,
              void* stream) {
  cudaError_t err =
      prepare(score_packed_kernel<LPT>, threads, smem, active);
  if (err != cudaSuccess) return (int)err;
  if (N > 0 && W > 0) {
    score_packed_kernel<LPT><<<dim3(W, N), threads, smem,
                               (cudaStream_t)stream>>>(
        (const int*)pidx, (const float*)tables, (const float*)tvecs,
        (const float*)xts, (const int*)lens, (const int*)starts,
        (const int*)codes, (float*)alt, (float*)nul, W, S, Kp, T);
  }
  return (int)cudaGetLastError();
}

template <int LPT>
int go_packed_chained(const void* pidx, const void* tables,
                      const void* tvecs, const void* run_sblk,
                      const void* run_len, const void* run_gst,
                      const void* win_sblk, const void* win_len,
                      const void* win_xti, const void* lut,
                      const void* codes, void* alt, void* nul, int N, int W,
                      int S, int C, int CR, int Kp, int T, int threads,
                      int smem, int* active, void* stream) {
  cudaError_t err =
      prepare(score_packed_chained_kernel<LPT>, threads, smem, active);
  if (err != cudaSuccess) return (int)err;
  if (N > 0 && W > 0 && C > 0) {
    score_packed_chained_kernel<LPT><<<dim3(W * C, N), threads, smem,
                                       (cudaStream_t)stream>>>(
        (const int*)pidx, (const float*)tables, (const float*)tvecs,
        (const int*)run_sblk, (const int*)run_len, (const int*)run_gst,
        (const int*)win_sblk, (const int*)win_len, (const int*)win_xti,
        (const float*)lut, (const int*)codes, (float*)alt, (float*)nul, W, S,
        C, CR, Kp, T);
  }
  return (int)cudaGetLastError();
}

}  // namespace

// Both end with the launch shape (lpt, threads, smem) of ops/viterbi.py
// packed_shape, an int* that gets the CTAs an SM holds at once (when not
// null) and the stream; a shape the kernels do not take is refused.
extern "C" int dtt_score_packed(
    const void* pidx, const void* tables, const void* tvecs, const void* xts,
    const void* lens, const void* starts, const void* codes, void* alt,
    void* nul, int N, int W, int S, int Kp, int T, int lpt, int threads,
    int smem, int* active, void* stream) {
  if (!packed_shape_ok(S, Kp, lpt, threads, smem))
    return (int)cudaErrorInvalidValue;
  return lpt == 2
             ? go_packed<2>(pidx, tables, tvecs, xts, lens, starts, codes,
                            alt, nul, N, W, S, Kp, T, threads, smem, active,
                            stream)
             : go_packed<4>(pidx, tables, tvecs, xts, lens, starts, codes,
                            alt, nul, N, W, S, Kp, T, threads, smem, active,
                            stream);
}

extern "C" int dtt_score_packed_chained(
    const void* pidx, const void* tables, const void* tvecs,
    const void* run_sblk, const void* run_len, const void* run_gst,
    const void* win_sblk, const void* win_len, const void* win_xti,
    const void* lut, const void* codes, void* alt, void* nul, int N, int W,
    int S, int C, int CR, int Kp, int T, int lpt, int threads, int smem,
    int* active, void* stream) {
  if (!packed_shape_ok(S, Kp, lpt, threads, smem) || CR <= 0)
    return (int)cudaErrorInvalidValue;
  return lpt == 2
             ? go_packed_chained<2>(pidx, tables, tvecs, run_sblk, run_len,
                                    run_gst, win_sblk, win_len, win_xti, lut,
                                    codes, alt, nul, N, W, S, C, CR, Kp, T,
                                    threads, smem, active, stream)
             : go_packed_chained<4>(pidx, tables, tvecs, run_sblk, run_len,
                                    run_gst, win_sblk, win_len, win_xti, lut,
                                    codes, alt, nul, N, W, S, C, CR, Kp, T,
                                    threads, smem, active, stream);
}
