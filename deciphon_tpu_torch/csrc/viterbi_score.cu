// Phase-1 score kernels (B1, B3, B5, B8, B4, B4m): null and alt min-plus
// costs of every scheduled window, the push/pending formulation of the
// frame Viterbi.  One DP body (`score_window`), six entry points:
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
//                                profile per slot with the state in a
//                                global scratch: the gang of a scorer
//                                whose tables stream per wave
//                                (`_scores_pairs_hbm_core`,
//                                `_gather_scores_pairs_hbm_mixed_jit`).
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
// per thread.  The 5-slot pending rings PM/PI (5 x Kp each) and the
// previous delete row (11 * Kp f32, the body's `state`) live in shared
// memory for B1, B3, B5 and B8 (44 * Kp bytes: 220 KB at Kp = 5120); the
// special states and their pending rings live in registers, computed
// redundantly by every thread, with ring slots made static by unrolling the
// position loop into 5 phases (as the Pallas kernel does).
//
// Large K (B4).  Past Kp = 5120 the state no longer fits a CTA's 227 KB
// (743 KB at Kp = 16896), so B4 runs the same body on the CTA's own slice
// of a global scratch of (N * W, 11 * Kp) f32 that the wrapper allocates
// per launch, 1024 threads per CTA (at most 17 lanes a thread).  The TPU
// kernel launched once per 40-position block, gathered the block's emission
// planes with XLA and carried its state through HBM between launches, all
// because VMEM could not hold the table; here the body reads emission rows
// from the table in place and one launch runs every window to its length.
// The state is written and read by the block itself, so it is read through
// plain pointers (never `const __restrict__` or __ldg, whose non-coherent
// path does not see the block's writes) and __syncthreads orders it as it
// does shared memory.  A launch's scratch stays in the 50 MB L2 only while
// about 50 windows of Kp 16896 are in flight.
//
// B4m is B4 with B5's profile per slot: the TPU ran it when a gang's table
// stack did not fit VMEM or streamed in per wave.  On the card no table is
// on-chip, so a resident gang stays on B5 at any stack size; a streamed
// gang takes B4m as the reference's does.  Both compute B5's function, so
// B4m equals B5 bit for bit; its scratch is N * W * 11 * Kp f32 (4.3 MB
// for 96 windows at Kp 1024).
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
// the (1364, Kp) table through L2) per window, far below L2 bandwidth;
// the kernel is bound by latency per position: one lane shift, one
// block-wide prefix min for the delete chain and one block-wide min for E,
// each a __syncthreads round.  Enough windows (CTAs) must be in flight to
// hide it; several windows per CTA and staged rows come in later work.
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
constexpr int kLargeThreads = 1024;  // B4: <= 17 lanes a thread at Kp 16896
constexpr int kCW = 8;  // carry slots per pair (viterbi_pallas.CW)
constexpr int kStatePlanes = 11;  // PM (5) | PI (5) | Dv (1), Kp f32 each

// Carry planes of one (pair, slot): plane j of big at big + j * kCW * Kp,
// plane j of small at sml + j * kCW.
struct Carry {
  const float* big_in = nullptr;
  const float* sml_in = nullptr;
  float* big_out = nullptr;
  float* sml_out = nullptr;
};

// The DP of one window: `len` positions of profile table/tv from code row
// `start`, (alt, null) written to *alt / *nul.  `state` holds the CTA's
// kStatePlanes * Kp f32, in shared memory or in its global scratch slice.
// Every thread of the CTA calls it; a length-0 window never gets here.
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

__device__ __forceinline__ void write_pad(float* alt, float* nul) {
  if (threadIdx.x == 0) {
    *alt = inf_f();
    *nul = inf_f();
  }
}

// B1 (kMixed false): blockIdx = (slot, pair), one profile per pair, pidx
// (N,).  B5: one profile per (pair, slot), pidx (N, W); the slot's
// transition rows are read in place (the reference gathers them per slot
// beforehand).
template <bool kMixed>
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
  score_window(tables + (size_t)p * kTableRows * Kp,
               tvecs + (size_t)p * 8 * Kp, xts + (size_t)sw * 16,
               starts[sw], len, codes, Kp, T, lpt, smem, Carry{}, alt + sw,
               nul + sw);
}

// B4 (kMixed false) and B4m: blockIdx = (slot, pair) as in B1 and B5; the
// state lives in the CTA's slice of `scratch` (N * W, kStatePlanes * Kp)
// f32, written and read by the block itself (so neither const nor
// __restrict__).  B4m reads pidx (N, W) and each slot's table and
// transition rows in place, as B5 does.
template <bool kMixed>
__global__ void __launch_bounds__(kLargeThreads, 1) score_large_kernel(
    const int* __restrict__ pidx, const float* __restrict__ tables,
    const float* __restrict__ tvecs, const float* __restrict__ xts,
    const int* __restrict__ lens, const int* __restrict__ starts,
    const int* __restrict__ codes, float* scratch, float* __restrict__ alt,
    float* __restrict__ nul, int W, int Kp, int T, int lpt) {
  const int n = blockIdx.y, w = blockIdx.x;
  const int sw = n * W + w;
  const int len = lens[sw];
  if (len <= 0) return write_pad(alt + sw, nul + sw);
  const int p = kMixed ? pidx[sw] : pidx[n];
  score_window(tables + (size_t)p * kTableRows * Kp,
               tvecs + (size_t)p * 8 * Kp, xts + (size_t)sw * 16,
               starts[sw], len, codes, Kp, T, lpt,
               scratch + (size_t)sw * kStatePlanes * Kp, Carry{}, alt + sw,
               nul + sw);
}

// B3 (kCarry false) and B8: blockIdx = (slot * C + entry, pair); xtrans
// rows from the per-scan LUT.  B8 reads and writes the carry planes.
template <bool kCarry>
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
  score_window(tables + (size_t)p * kTableRows * Kp,
               tvecs + (size_t)p * 8 * Kp, lut + (size_t)xti[e] * 16,
               gst[e], len, codes, Kp, T, lpt, smem, cy, alt + e, nul + e);
}

// Threads per CTA and lanes per thread for lane width Kp.
void shape(int Kp, int* threads, int* lpt) {
  *threads = Kp < kScoreThreads ? Kp : kScoreThreads;
  *lpt = (Kp + *threads - 1) / *threads;
}

// Shared memory of one CTA for lane width Kp (the DP state).
size_t smem_bytes(int Kp) {
  return (size_t)kStatePlanes * Kp * sizeof(float);
}

template <typename K>
cudaError_t allow_smem(K kernel, int Kp) {
  return cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem_bytes(Kp));
}

}  // namespace

template <bool kMixed>
static int launch_pairs(const void* pidx, const void* tables,
                        const void* tvecs, const void* xts, const void* lens,
                        const void* starts, const void* codes, void* alt,
                        void* nul, int N, int W, int Kp, int T,
                        void* stream) {
  int threads, lpt;
  shape(Kp, &threads, &lpt);
  cudaError_t err = allow_smem(score_pairs_kernel<kMixed>, Kp);
  if (err != cudaSuccess) return (int)err;
  if (N > 0 && W > 0) {
    score_pairs_kernel<kMixed><<<dim3(W, N), threads, smem_bytes(Kp),
                                 (cudaStream_t)stream>>>(
        (const int*)pidx, (const float*)tables, (const float*)tvecs,
        (const float*)xts, (const int*)lens, (const int*)starts,
        (const int*)codes, (float*)alt, (float*)nul, W, Kp, T, lpt);
  }
  return (int)cudaGetLastError();
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

template <bool kCarry>
static int launch_chained(const void* pidx, const void* tables,
                          const void* tvecs, const void* wlen,
                          const void* gst, const void* xti, const void* lut,
                          const void* codes, const void* conts,
                          const void* cbig_in, const void* csml_in,
                          void* cbig_out, void* csml_out, void* alt,
                          void* nul, int N, int W, int C, int Kp, int T,
                          void* stream) {
  int threads, lpt;
  shape(Kp, &threads, &lpt);
  cudaError_t err = allow_smem(score_chained_kernel<kCarry>, Kp);
  if (err != cudaSuccess) return (int)err;
  if (N > 0 && W > 0 && C > 0) {
    score_chained_kernel<kCarry><<<dim3(W * C, N), threads, smem_bytes(Kp),
                           (cudaStream_t)stream>>>(
        (const int*)pidx, (const float*)tables, (const float*)tvecs,
        (const int*)wlen, (const int*)gst, (const int*)xti,
        (const float*)lut, (const int*)codes, (const int*)conts,
        (const float*)cbig_in, (const float*)csml_in, (float*)cbig_out,
        (float*)csml_out, (float*)alt, (float*)nul, W, C, Kp, T, lpt);
  }
  return (int)cudaGetLastError();
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

template <bool kMixed>
static int launch_large(const void* pidx, const void* tables,
                        const void* tvecs, const void* xts, const void* lens,
                        const void* starts, const void* codes, void* scratch,
                        void* alt, void* nul, int N, int W, int Kp, int T,
                        void* stream) {
  const int threads = Kp < kLargeThreads ? Kp : kLargeThreads;
  const int lpt = (Kp + threads - 1) / threads;
  if (N > 0 && W > 0) {
    score_large_kernel<kMixed><<<dim3(W, N), threads, 0,
                                 (cudaStream_t)stream>>>(
        (const int*)pidx, (const float*)tables, (const float*)tvecs,
        (const float*)xts, (const int*)lens, (const int*)starts,
        (const int*)codes, (float*)scratch, (float*)alt, (float*)nul, W, Kp,
        T, lpt);
  }
  return (int)cudaGetLastError();
}

// B4 and B4m: scratch is (N * W, 11 * Kp) f32 (ops/viterbi.py allocates
// it); pidx is (N,) for B4 and (N, W) for B4m.
extern "C" int dtt_score_pairs_large(
    const void* pidx, const void* tables, const void* tvecs, const void* xts,
    const void* lens, const void* starts, const void* codes, void* scratch,
    void* alt, void* nul, int N, int W, int Kp, int T, void* stream) {
  return launch_large<false>(pidx, tables, tvecs, xts, lens, starts, codes,
                             scratch, alt, nul, N, W, Kp, T, stream);
}

extern "C" int dtt_score_mixed_large(
    const void* pidx, const void* tables, const void* tvecs, const void* xts,
    const void* lens, const void* starts, const void* codes, void* scratch,
    void* alt, void* nul, int N, int W, int Kp, int T, void* stream) {
  return launch_large<true>(pidx, tables, tvecs, xts, lens, starts, codes,
                            scratch, alt, nul, N, W, Kp, T, stream);
}

extern "C" const char* dtt_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}
