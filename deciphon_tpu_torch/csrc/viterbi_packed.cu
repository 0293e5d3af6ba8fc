// Lane-packed phase-1 score kernels (B6, B7): S small profiles side by
// side on one plane of Kp = S * seg lanes, segment s on lanes
// [s * seg, (s + 1) * seg), every segment scanning a window of the same
// code stream.  Two entry points over one DP body (`score_window_packed`):
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
// `score_window`'s (viterbi_score.cu) in the same f32 operation order; what
// packing changes is kept exactly as the reference has it:
//
//   * tables: a row of 2 * Kp + 128 floats = match costs per segment | the
//     owning segment's background cost replicated over its lanes | the
//     segments' null costs in columns 2 * Kp + s; the DD cumulative sum of
//     the transition vectors restarts per segment;
//   * the special states [S B N J C E R] and the pending N/J/C/R rings are
//     per segment: a thread owns lanes of one segment only and carries that
//     segment's specials in registers (every thread of a segment computes
//     the same values);
//   * the delete-chain prefix min never crosses a segment boundary and E
//     is one minimum per segment (`seg_excl_prefix_min`, `seg_min`);
//   * the lane shift is unmasked and wraps lane 0 to lane Kp - 1, as the
//     reference's: every profile has K + 1 <= seg, so the last lane of each
//     segment is a +inf pad and nothing finite crosses a boundary.
//
// Mapping.  One CTA scans one slot's window (B6) or one chain entry index
// c of one slot (B7) for all S segments at once; the position loop runs in
// the block.  seg is a multiple of 64 and Kp <= 2048, so with 1, 2 or 4
// lanes per thread no thread straddles a segment and a segment is a whole
// number of 16-thread groups.  Shared memory: the PM/PI rings and the
// delete row, 44 * Kp bytes (88 KB at Kp 2048).
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
// Entries of length 0 (pads) write +inf.
//
// What bounds it: as `score_window`, latency per position (a lane shift,
// a segmented prefix min and a segmented min, each a __syncthreads round),
// not bytes: 5 rows of 2 * Kp + 128 floats per position through L2.
#include "common.cuh"

namespace {

using namespace dtt;

constexpr int kKappa = 40;  // positions per chain block (KAPPA_PENDING)

// The slot's shared code stream: runs (start block, nt, first code row).
struct Runs {
  const int* sblk = nullptr;
  const int* len = nullptr;
  const int* gst = nullptr;
  int n = 0;
};

// First code row of chain block b.
__device__ __forceinline__ int run_base(const Runs& rn, int b) {
  for (int c = 0; c < rn.n; ++c) {
    const int L = rn.len[c];
    if (L > 0 && rn.sblk[c] <= b && b < rn.sblk[c] + (L + kKappa - 1) / kKappa)
      return rn.gst[c] + (b - rn.sblk[c]) * kKappa;
  }
  return rn.gst[0];
}

// The DP of one CTA: this thread's segment scans `len` positions (0: an
// idle segment) with xtrans row xtp; maxlen is the CTA's longest.  B6
// passes rn.n == 0 and the window's first code row in `start`; B7 the run
// chain and the window's first chain block in `start`.
__device__ __forceinline__ void score_window_packed(
    const float* __restrict__ table, const float* __restrict__ tv,
    const float* __restrict__ xtp, int start, int len, int maxlen,
    const Runs rn, const int* __restrict__ codes, int Kp, int seg, int T,
    int lpt, float* alt, float* nul) {
  extern __shared__ float smem[];
  float* PM = smem;           // [5][Kp] pending M
  float* PI = PM + 5 * Kp;    // [5][Kp] pending I
  float* Dv = PI + 5 * Kp;    // [Kp] previous D, then the pushed inner
  float* red = Dv + Kp;       // [32] reduction scratch
  const float INF = inf_f();
  const int Wt = 2 * Kp + 128;

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
  const int k0 = (int)threadIdx.x * lpt;
  const int k1 = k0 + lpt;
  const int s = k0 / seg;            // this thread's segment
  const int tps = seg / lpt;         // threads per segment
  const int sf = s * tps;            // first thread of the segment
  const int bgcol = Kp + s * seg;    // the segment's background column
  const int nilcol = 2 * Kp + s;     // the segment's null column

  for (int k = threadIdx.x; k < 5 * Kp; k += blockDim.x) {
    PM[k] = INF;
    PI[k] = INF;
  }
  for (int k = threadIdx.x; k < Kp; k += blockDim.x) Dv[k] = INF;
  // specials of the previous position [S B N J C E R] and the pending
  // N/J/C/R rings of this thread's segment
  float ss[7];
  float psm[4][5];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 5; ++j) psm[i][j] = INF;
  ss[0] = 0.f;
  ss[1] = xt[XT_SB];
  ss[2] = ss[3] = ss[4] = ss[5] = INF;
  ss[6] = -xt[XT_RR];
  __syncthreads();
  float Tfin = INF, Rfin = INF;
  int base = 0;  // code row of the current block's first position

  for (int l0 = 0; l0 < maxlen; l0 += 5) {
    if (l0 % kKappa == 0)
      base = rn.n > 0 ? run_base(rn, start + l0 / kKappa) : start + l0;
#pragma unroll
    for (int r = 0; r < 5; ++r) {
      const int l = l0 + r + 1;  // l % 5 == (r + 1) % 5
      if (l > maxlen) break;
      // rows of the 5 fragments STARTING at position l
      const int crow = min(max(base + l0 % kKappa + r, 0), T - 1);
      const float* er[5];
#pragma unroll
      for (int t = 0; t < 5; ++t)
        er[t] = table + (size_t)codes[(size_t)crow * 5 + t] * Wt;

      // -- inner = min(min(sm+MMs, si+IMs), sd+DMs) into Dv -------------
      const float* sm = PM + r * Kp;  // M_{l-1} sits in slot (l-1)%5 == r
      const float* si = PI + r * Kp;
      for (int k = k0; k < k1; ++k)
        Dv[k] = fminf(fminf(sm[k] + tMMS[k], si[k] + tIMS[k]),
                      Dv[k] + tDMS[k]);
      __syncthreads();

      // -- push the contributions of state l-1 -------------------------
      const float Bprev = ss[1];
      float bg[5], nil[5];
#pragma unroll
      for (int t = 0; t < 5; ++t) {
        bg[t] = er[t][bgcol];
        nil[t] = er[t][nilcol];
      }
      for (int k = k0; k < k1; ++k) {
        const int km = k == 0 ? Kp - 1 : k - 1;
        const float contrib = fminf(Dv[km], Bprev + tBM[k]);
        const float icand = fminf(si[k] + tII[k], sm[k] + tMI[k]);
#pragma unroll
        for (int t = 1; t <= 5; ++t) {
          const int st = (r + t) % 5;  // (l-1+t) % 5
          const float em = er[t - 1][k];
          if (t == 5) {  // slot consumed at l-1: fresh assignment
            PM[st * Kp + k] = contrib + em;
            PI[st * Kp + k] = icand + bg[t - 1];
          } else {
            PM[st * Kp + k] = fminf(PM[st * Kp + k], contrib + em);
            PI[st * Kp + k] = fminf(PI[st * Kp + k], icand + bg[t - 1]);
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
          if (t == 5) {
            psm[0][st] = cN + nil[t - 1];
            psm[1][st] = cJ + nil[t - 1];
            psm[2][st] = cC + nil[t - 1];
            psm[3][st] = cR + nil[t - 1];
          } else {
            psm[0][st] = fminf(psm[0][st], cN + nil[t - 1]);
            psm[1][st] = fminf(psm[1][st], cJ + nil[t - 1]);
            psm[2][st] = fminf(psm[2][st], cC + nil[t - 1]);
            psm[3][st] = fminf(psm[3][st], cR + nil[t - 1]);
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
      float run = seg_excl_prefix_min(loc, red, sf);
      float emin = INF;
      for (int k = k0; k < k1; ++k) {
        const int km = k == 0 ? Kp - 1 : k - 1;
        const float A = Ml[km] + tMD[k];
        run = fminf(run, A - tDDC[k]);
        const float D = run + tDDC[k];
        Dv[k] = D;
        emin = fminf(emin, fminf(Ml[k], D));
      }
      const float E = seg_min(emin, red, sf, tps);
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
  if ((int)threadIdx.x == sf) {
    *alt = Tfin;
    *nul = Rfin;
  }
}

// B6: blockIdx = (slot, pair); alt/nul (N, W, S).
__global__ void __launch_bounds__(512) score_packed_kernel(
    const int* __restrict__ pidx, const float* __restrict__ tables,
    const float* __restrict__ tvecs, const float* __restrict__ xts,
    const int* __restrict__ lens, const int* __restrict__ starts,
    const int* __restrict__ codes, float* __restrict__ alt,
    float* __restrict__ nul, int W, int S, int Kp, int T, int lpt) {
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
  const int p = pidx[n];
  const int seg = Kp / S;
  const int s = (int)threadIdx.x * lpt / seg;
  score_window_packed(tables + (size_t)p * kTableRows * (2 * Kp + 128),
                      tvecs + (size_t)p * 8 * Kp, xts + (size_t)sw * 16,
                      starts[sw], len, len, Runs{}, codes, Kp, seg, T, lpt,
                      alt + (size_t)sw * S + s, nul + (size_t)sw * S + s);
}

// B7: blockIdx = (slot * C + entry, pair); run_* (N, W, CR), win_*
// (N, W, S, C), alt/nul (N, W, S, C).
__global__ void __launch_bounds__(512) score_packed_chained_kernel(
    const int* __restrict__ pidx, const float* __restrict__ tables,
    const float* __restrict__ tvecs, const int* __restrict__ run_sblk,
    const int* __restrict__ run_len, const int* __restrict__ run_gst,
    const int* __restrict__ win_sblk, const int* __restrict__ win_len,
    const int* __restrict__ win_xti, const float* __restrict__ lut,
    const int* __restrict__ codes, float* __restrict__ alt,
    float* __restrict__ nul, int W, int S, int C, int CR, int Kp, int T,
    int lpt) {
  const int n = blockIdx.y;
  const int w = blockIdx.x / C, c = blockIdx.x % C;
  const size_t sw = (size_t)n * W + w;
  const int seg = Kp / S;
  const int s = (int)threadIdx.x * lpt / seg;
  const size_t e = (sw * S + s) * C + c;  // this segment's entry
  int maxlen = 0;
  for (int j = 0; j < S; ++j)
    maxlen = max(maxlen, win_len[(sw * S + j) * C + c]);
  if (maxlen <= 0) {
    if ((int)threadIdx.x < S) {
      alt[(sw * S + threadIdx.x) * C + c] = inf_f();
      nul[(sw * S + threadIdx.x) * C + c] = inf_f();
    }
    return;
  }
  Runs rn;
  rn.sblk = run_sblk + sw * CR;
  rn.len = run_len + sw * CR;
  rn.gst = run_gst + sw * CR;
  rn.n = CR;
  const int p = pidx[n];
  score_window_packed(tables + (size_t)p * kTableRows * (2 * Kp + 128),
                      tvecs + (size_t)p * 8 * Kp,
                      lut + (size_t)win_xti[e] * 16, win_sblk[e],
                      max(win_len[e], 0), maxlen, rn, codes, Kp, seg, T, lpt,
                      alt + e, nul + e);
}

// Lanes per thread for a packed plane: 1, 2 or 4, so that at most 512
// threads cover Kp <= 2048 lanes and divide every 64-lane multiple.
int packed_lpt(int Kp) { return Kp > 1024 ? 4 : Kp > 512 ? 2 : 1; }

size_t packed_smem(int Kp) {
  return (size_t)(11 * Kp + kMaxWarps) * sizeof(float);
}

// cudaErrorInvalidValue unless the plane is one the kernels take.
bool packed_shape_ok(int S, int Kp) {
  return S > 0 && Kp > 0 && Kp <= 2048 && Kp % 128 == 0 && Kp % S == 0 &&
         (Kp / S) % 64 == 0;
}

}  // namespace

extern "C" int dtt_score_packed(
    const void* pidx, const void* tables, const void* tvecs, const void* xts,
    const void* lens, const void* starts, const void* codes, void* alt,
    void* nul, int N, int W, int S, int Kp, int T, void* stream) {
  if (!packed_shape_ok(S, Kp)) return (int)cudaErrorInvalidValue;
  const int lpt = packed_lpt(Kp);
  cudaError_t err = cudaFuncSetAttribute(
      score_packed_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)packed_smem(Kp));
  if (err != cudaSuccess) return (int)err;
  if (N > 0 && W > 0) {
    score_packed_kernel<<<dim3(W, N), Kp / lpt, packed_smem(Kp),
                          (cudaStream_t)stream>>>(
        (const int*)pidx, (const float*)tables, (const float*)tvecs,
        (const float*)xts, (const int*)lens, (const int*)starts,
        (const int*)codes, (float*)alt, (float*)nul, W, S, Kp, T, lpt);
  }
  return (int)cudaGetLastError();
}

extern "C" int dtt_score_packed_chained(
    const void* pidx, const void* tables, const void* tvecs,
    const void* run_sblk, const void* run_len, const void* run_gst,
    const void* win_sblk, const void* win_len, const void* win_xti,
    const void* lut, const void* codes, void* alt, void* nul, int N, int W,
    int S, int C, int CR, int Kp, int T, void* stream) {
  if (!packed_shape_ok(S, Kp) || CR <= 0) return (int)cudaErrorInvalidValue;
  const int lpt = packed_lpt(Kp);
  cudaError_t err = cudaFuncSetAttribute(
      score_packed_chained_kernel,
      cudaFuncAttributeMaxDynamicSharedMemorySize, (int)packed_smem(Kp));
  if (err != cudaSuccess) return (int)err;
  if (N > 0 && W > 0 && C > 0) {
    score_packed_chained_kernel<<<dim3(W * C, N), Kp / lpt, packed_smem(Kp),
                                  (cudaStream_t)stream>>>(
        (const int*)pidx, (const float*)tables, (const float*)tvecs,
        (const int*)run_sblk, (const int*)run_len, (const int*)run_gst,
        (const int*)win_sblk, (const int*)win_len, (const int*)win_xti,
        (const float*)lut, (const int*)codes, (float*)alt, (float*)nul, W, S,
        C, CR, Kp, T, lpt);
  }
  return (int)cudaGetLastError();
}
