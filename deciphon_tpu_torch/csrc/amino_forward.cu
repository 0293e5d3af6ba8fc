// Amino Forward and posterior kernels: the HMMER3 local multihit Forward of
// an amino sequence against one profile (nats), and Forward + Backward
// posterior state usages for the null2 bias; one CTA a hit, a launch a
// batch of hits of one Kpad spread over the SMs.
//
// Replaces deciphon_tpu/hmmer/forward.py `_jit_forward` (a lax.scan over
// the amino positions: log-sum-exp over M, I and D, the D chain as an
// associative log-add scan, the N, B, E, J and C specials) and
// `_jit_posterior` (that Forward, then Backward, then the usages gM (Kpad,),
// gI and gNCJ).  Both are XLA, not Pallas.
//
// Arithmetic.  Scaled odds space, as HMMER3's own production Forward and
// Backward (p7_ForwardParser / p7_BackwardParser) run, instead of the
// reference's log space: the kernels take the same log tensors and
// exponentiate them as they load them (the pad sentinels _NEG and
// _NEG / Kpad, and the lanes of threads past Kpad, become exact zeros).
// A Forward row is then sums of products; after each position every
// thread holds the same row total s of the specials (N + B + E + J + C)
// and the next position multiplies the carried row by 2^-e, s = m 2^e with
// m in [0.5, 1): a power of two, so the scaling rounds nothing and the
// Forward in nats is log(E xET + C xCT) + ln 2 (sum of e), the sum exact.
// The Backward runs on the Forward's scales (row l of the Forward scaled
// by the product of the scales up to l, the Backward's by those past l), so
// a usage is f b r_l / Q, Q the last row's total, with no exp of terms of
// hundreds of nats.  Sums of non-negative terms in f32 lose no more than
// the log-space form; underflow drops only terms below 1e-38 of a row
// whose total is near 1.  Results agree with the reference (and with the
// plain versions in hmmer/forward.py, which follow it op for op in log
// space) within a tolerance, not bit for bit.  A CTA's result depends on
// its own hit alone, so a batch's rows are bit-equal to the same hits
// launched one at a time.  Built without fast math: expf is the precise
// one, and fmaf the explicit fused multiply-add.
//
// What bounds it.  A position is a chain: every lane's products and the
// D chain's affine composition, warp shuffle scans and sums on each side
// of one barrier, the specials.  The FMAs a (position, node) cell (about
// 12 in the Forward, 14 more in the Backward) over a CTA's lanes are a few
// hundred clocks of one SM's FMA pipes at Kpad 2048; the shuffle stages
// (5 steps each, some 30 clocks a step) and the barrier set the pace.  The
// emission row's expf (one a lane) depends on no state and is issued one
// position ahead.  A wave's hits run side by side, one CTA on each SM, so
// a launch lasts as long as its longest hit.
//
// Design.  Thread t owns LPT consecutive lanes k (LPT 4 up to Kpad 2048, 8
// up to 8192, 16 at 16384; Kpad / LPT threads, at least one warp) and
// keeps their M, I and D (Backward: bM, bI and the gM sums) in registers;
// LPT 4 measured faster than 8 at Kpad 1024-2048.  The 1024-thread
// instances (Kpad 8192 and 16384, 64 registers a thread) hold more than
// that and spill.
// The odds of the transition vectors are staged once per CTA into shared
// memory up to Kpad 4096 (9 x Kpad x 4 B) and past it into the launch's
// scratch `odds` (H, 9, Kpad), read through L1/L2.  One barrier a
// position; the per-warp slots it publishes are double-buffered by the
// position's parity.  A Forward position:
//   * M'[k] = e_k (inner[k-1] + B tbm[k]), inner = M tmm + I tim + D tdm of
//     the previous row; the neighbour's inner by __shfl_up_sync, across
//     warps from the slot (p, q) that the warp below published in the
//     previous position: inner = p + q X, X the D value entering that warp,
//     known after the barrier;  I'[k] = M tmi + I tii;
//   * the D chain d'[k + 1] = M'[k] tmd[k + 1] + tdd[k + 1] d'[k] as an
//     affine scan of pairs (a, g), composed (a2 + g2 a1, g1 g2): the
//     thread's lanes in FMAs, a warp shuffle scan, then after the barrier
//     every warp scans the warps' totals; the lanes then take d' in FMAs;
//   * E = sum M' + sum D'.  Sum D' of a warp is linear in the D value
//     entering it (u + v X), so both sums are published before the barrier;
//   * the specials, computed by every thread from the same shared partials
//     (the same bits everywhere, so no broadcast round), and the scale.
// The Backward runs l = L..1 on the same plan: mb = e bM of position l + 1
// and bB's sum before the barrier; the bD suffix is the mirrored affine
// scan, bD[k] = alpha[k] + beta[k] bE, where beta (the chain of bE's own
// entries, a property of the profile) is scanned once in the prologue and
// alpha's pairs alpha[k] = tdm[k] mb[k + 1] + tdd[k + 1] alpha[k + 1] are
// scanned before the barrier (a warp's top lane, whose mb[k + 1] lies in
// the warp above, is composed after it).  It reads the Forward's M and I
// rows, and N, J, C and the row's scale, from a global scratch of
// (8 Kpad + 16) L bytes that the posterior's Forward wrote; the reads and
// writes of a lane are the same thread's.
#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr unsigned kFull = 0xffffffffu;
constexpr float kNeg = -1e30f;  // forward.py _NEG (the Forward of L = 0)
constexpr int kRows = 21;       // odds-table rows: 20 aminos, degenerate
// rows of the transition-vector table tv (hmmer/forward.py TV_*)
enum { TV_MM, TV_IM, TV_DM, TV_MI, TV_II, TV_MD, TV_DD, TV_BM, TV_DV, TV_S,
       TV_SREV, kTvRows };
// the special-state scores of a hit (hmmer/forward.py X_*)
enum { X_NN, X_NB, X_EJC, X_JJ, X_JB, X_EB, X_ECC, X_CC, X_ET, X_CT, kXv };
// staged odds rows: tdm masked to the real D lanes, tmd and tdd of the
// next lane (k + 1; 0 past Kpad), and the Backward's beta of the next lane
enum { O_MM, O_IM, O_DM, O_MI, O_II, O_MDN, O_DDN, O_BM, O_BETAN, kOdds };
constexpr int kXf = 4;            // X scratch: N, J, C and the row's scale
constexpr int kSmemMaxKp = 4096;  // odds in shared memory up to this Kpad
constexpr int kMaxKp = 16384;
constexpr double kLn2 = 0.69314718055994530942;

// Affine pairs x -> a + g x.  Inclusive scans over the first n lanes of a
// warp (n a power of two, the same in every lane): upward, lane i composes
// lanes 0..i (lowest applied first); downward, lanes i..n-1 (highest
// first).
__device__ __forceinline__ void warp_scan_up(float& a, float& g, int lane,
                                             int n = 32) {
#pragma unroll
  for (int o = 1; o < n; o <<= 1) {
    const float au = __shfl_up_sync(kFull, a, o);
    const float gu = __shfl_up_sync(kFull, g, o);
    if (lane >= o) {
      a = fmaf(g, au, a);
      g *= gu;
    }
  }
}

__device__ __forceinline__ void warp_scan_down(float& a, float& g, int lane,
                                               int n = 32) {
#pragma unroll
  for (int o = 1; o < n; o <<= 1) {
    const float ad = __shfl_down_sync(kFull, a, o);
    const float gd = __shfl_down_sync(kFull, g, o);
    if (lane + o < n) {
      a = fmaf(g, ad, a);
      g *= gd;
    }
  }
}

// Warp sum by butterflies: every lane gets the same bits.
__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(kFull, v, o);
  return v;
}

template <int LPT>
__device__ __forceinline__ void load_lanes(float (&v)[LPT], const float* p) {
#pragma unroll
  for (int j = 0; j < LPT; j += 4) {
    const float4 q = *reinterpret_cast<const float4*>(p + j);
    v[j] = q.x;
    v[j + 1] = q.y;
    v[j + 2] = q.z;
    v[j + 3] = q.w;
  }
}

template <int LPT>
__device__ __forceinline__ void store_lanes(float* p, const float (&v)[LPT]) {
#pragma unroll
  for (int j = 0; j < LPT; j += 4)
    *reinterpret_cast<float4*>(p + j) = make_float4(v[j], v[j + 1], v[j + 2],
                                                    v[j + 3]);
}

// One CTA a hit h: residues res[off[h] .. off[h+1]), log-odds table
// em (H, 21, Kpad), log vectors tv (H, 11, Kpad), specials xv (H, 10).
// kPost = false: out[h] = forward nats.  kPost = true: out (H, 3 + Kpad) =
// (fwd, gI, gNCJ, gM...), with the scratch Mf, If (N, Kpad) and X (N, 4).
// `odds` (H, 9, Kpad): the staged odds past kSmemMaxKp (else unused).
template <int LPT, int kMaxThreads, bool kPost>
__global__ void __launch_bounds__(kMaxThreads)
    amino_kernel(const float* __restrict__ em, const float* __restrict__ tv,
                 const int* __restrict__ res, const int* __restrict__ off,
                 const float* __restrict__ xv, int Kpad, float* odds,
                 float* __restrict__ out, float* __restrict__ Mf,
                 float* __restrict__ If, float* __restrict__ Xf) {
  extern __shared__ float4 s_dyn[];
  // per-warp slots, double-buffered by the position's parity
  __shared__ float s_a[2][32], s_g[2][32], s_s[2][32], s_u[2][32],
      s_v[2][32], s_p[2][32], s_q[2][32];
  const int h = blockIdx.x;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int nwarps = blockDim.x >> 5;
  const int k0 = tid * LPT;
  const bool live = k0 < Kpad;
  const int base = off[h];
  const int L = off[h + 1] - base;
  const int* seq = res + base;
  const float* emh = em + (size_t)h * kRows * Kpad;
  const float* T = tv + (size_t)h * kTvRows * Kpad;
  float* O = Kpad <= kSmemMaxKp ? reinterpret_cast<float*>(s_dyn)
                                : odds + (size_t)h * kOdds * Kpad;
  for (int k = tid; k < Kpad; k += blockDim.x) {
    const bool nx = k + 1 < Kpad;
    O[O_MM * Kpad + k] = expf(T[TV_MM * Kpad + k]);
    O[O_IM * Kpad + k] = expf(T[TV_IM * Kpad + k]);
    O[O_DM * Kpad + k] =
        T[TV_DV * Kpad + k] > 0.f ? expf(T[TV_DM * Kpad + k]) : 0.f;
    O[O_MI * Kpad + k] = expf(T[TV_MI * Kpad + k]);
    O[O_II * Kpad + k] = expf(T[TV_II * Kpad + k]);
    O[O_MDN * Kpad + k] = nx ? expf(T[TV_MD * Kpad + k + 1]) : 0.f;
    O[O_DDN * Kpad + k] = nx ? expf(T[TV_DD * Kpad + k + 1]) : 0.f;
    O[O_BM * Kpad + k] = expf(T[TV_BM * Kpad + k]);
  }
  __syncthreads();
  const float* oMM = O + O_MM * Kpad;
  const float* oIM = O + O_IM * Kpad;
  const float* oDM = O + O_DM * Kpad;
  const float* oMI = O + O_MI * Kpad;
  const float* oII = O + O_II * Kpad;
  const float* oMDN = O + O_MDN * Kpad;
  const float* oDDN = O + O_DDN * Kpad;
  const float* oBM = O + O_BM * Kpad;
  const float* oBETAN = O + O_BETAN * Kpad;

  if (kPost) {
    // beta[k] = dvalid[k] + tdd[k + 1] beta[k + 1], staged as beta[k + 1]:
    // the thread's composite, the warp's suffix scan, then the warps'
    float a = 0.f, g = 0.f, dv[LPT], dd[LPT];
    if (live) {
      g = 1.f;
#pragma unroll
      for (int j = LPT - 1; j >= 0; --j) {
        dv[j] = T[TV_DV * Kpad + k0 + j] > 0.f ? 1.f : 0.f;
        dd[j] = oDDN[k0 + j];
        a = fmaf(dd[j], a, dv[j]);
        g *= dd[j];
      }
    }
    warp_scan_down(a, g, lane);
    float ea = __shfl_down_sync(kFull, a, 1);
    float eg = __shfl_down_sync(kFull, g, 1);
    if (lane == 31) {
      ea = 0.f;
      eg = 1.f;
    }
    if (lane == 0) {
      s_a[0][warp] = a;
      s_g[0][warp] = g;
    }
    __syncthreads();
    float wa = lane < nwarps ? s_a[0][lane] : 0.f;
    float wg = lane < nwarps ? s_g[0][lane] : 0.f;
    warp_scan_down(wa, wg, lane, nwarps);
    float cw = __shfl_down_sync(kFull, wa, 1);  // beta past warp `lane`
    if (lane + 1 >= nwarps) cw = 0.f;
    cw = __shfl_sync(kFull, cw, warp);
    if (live) {
      float c = fmaf(eg, cw, ea);  // beta[k0 + LPT]
#pragma unroll
      for (int j = LPT - 1; j >= 0; --j) {
        O[O_BETAN * Kpad + k0 + j] = c;
        c = fmaf(dd[j], c, dv[j]);
      }
    }
    __syncthreads();
  }

  float xo[kXv];
#pragma unroll
  for (int i = 0; i < kXv; ++i) xo[i] = expf(xv[h * kXv + i]);

  // ---- Forward: rows carried unscaled, multiplied by r at the next ----
  float M[LPT], I[LPT], D[LPT], en[LPT];
#pragma unroll
  for (int j = 0; j < LPT; ++j) M[j] = I[j] = D[j] = en[j] = 0.f;
  float N = 1.f, B = xo[X_NB], E = 0.f, J = 0.f, C = 0.f;  // S->N = 1
  float r = 1.f;   // the previous row's scale, 2^-e
  int esum = 0;    // the sum of e
  float up = 0.f;  // lane 0: the previous row's inner below the warp
  if (L > 0 && live) load_lanes(en, emh + (size_t)seq[0] * Kpad + k0);
  for (int p = 0; p < L; ++p) {
    const int b = p & 1;
    float e[LPT], inn[LPT];
#pragma unroll
    for (int j = 0; j < LPT; ++j) e[j] = expf(en[j]);
    if (p + 1 < L && live)  // the next position's row, one position ahead
      load_lanes(en, emh + (size_t)seq[p + 1] * Kpad + k0);
    if (live) {
      float mm[LPT], im[LPT], dm[LPT];
      load_lanes(mm, oMM + k0);
      load_lanes(im, oIM + k0);
      load_lanes(dm, oDM + k0);
#pragma unroll
      for (int j = 0; j < LPT; ++j)
        inn[j] = fmaf(D[j], dm[j], fmaf(I[j], im[j], M[j] * mm[j]));
    } else {
#pragma unroll
      for (int j = 0; j < LPT; ++j) inn[j] = 0.f;
    }
    float nb = __shfl_up_sync(kFull, inn[LPT - 1], 1);
    if (lane == 0) nb = up;
    // M', I'; the D chain's pairs composed upward: (ca, cg) takes the D
    // value entering the thread to the one past lane j; (sa, sg) the sum
    // of its lanes' D', (la, lg) its top lane's
    float ca = 0.f, cg = 1.f, sa = 0.f, sg = 0.f, la = 0.f, lg = 1.f;
    float sm = 0.f;
    if (live) {
      float bm[LPT], mi[LPT], ii[LPT], md[LPT], dd[LPT];
      load_lanes(bm, oBM + k0);
      load_lanes(mi, oMI + k0);
      load_lanes(ii, oII + k0);
      load_lanes(md, oMDN + k0);
      load_lanes(dd, oDDN + k0);
      const float Bs = B * r;
#pragma unroll
      for (int j = 0; j < LPT; ++j) {
        const float m = e[j] * fmaf(j ? inn[j - 1] : nb, r, Bs * bm[j]);
        I[j] = fmaf(I[j], ii[j], M[j] * mi[j]) * r;
        M[j] = m;
        sm += m;
        sa += ca;
        sg += cg;
        la = ca;
        lg = cg;
        ca = fmaf(dd[j], ca, m * md[j]);
        cg *= dd[j];
      }
    }
    float ia = ca, ig = cg;
    warp_scan_up(ia, ig, lane);
    float ea = __shfl_up_sync(kFull, ia, 1);
    float eg = __shfl_up_sync(kFull, ig, 1);
    if (lane == 0) {
      ea = 0.f;
      eg = 1.f;
    }
    // the thread's entering D is ea + eg X, X the D value entering the warp
    sm = warp_sum(sm);
    const float u = warp_sum(fmaf(sg, ea, sa));
    const float v = warp_sum(sg * eg);
    if (lane == 31) {
      s_a[b][warp] = ia;
      s_g[b][warp] = ig;
      float pp = 0.f, qq = 0.f;  // the top lane's inner as pp + qq X
      if (live) {
        const int k = k0 + LPT - 1;
        pp = fmaf(fmaf(lg, ea, la), oDM[k],
                  fmaf(I[LPT - 1], oIM[k], M[LPT - 1] * oMM[k]));
        qq = lg * eg * oDM[k];
      }
      s_p[b][warp] = pp;
      s_q[b][warp] = qq;
    }
    if (lane == 0) {
      s_s[b][warp] = sm;
      s_u[b][warp] = u;
      s_v[b][warp] = v;
    }
    if (kPost && live) {
      store_lanes(Mf + (size_t)(base + p) * Kpad + k0, M);
      store_lanes(If + (size_t)(base + p) * Kpad + k0, I);
    }
    __syncthreads();  // the position's one barrier
    float wa = 0.f, wg = 0.f;
    if (lane < nwarps) {
      wa = s_a[b][lane];
      wg = s_g[b][lane];
    }
    warp_scan_up(wa, wg, lane, nwarps);
    float X = __shfl_up_sync(kFull, wa, 1);  // the D value entering warp
    if (lane == 0) X = 0.f;                  // `lane`
    float ws = 0.f, wt = 0.f;
    if (lane < nwarps) {
      ws = s_s[b][lane];
      wt = fmaf(s_v[b][lane], X, s_u[b][lane]);
    }
    const float Ee = warp_sum(ws) + warp_sum(wt);
    const float Xw = __shfl_sync(kFull, X, warp);
    const float Xb = __shfl_sync(kFull, X, warp ? warp - 1 : 0);
    up = warp ? fmaf(s_q[b][warp - 1], Xb, s_p[b][warp - 1]) : 0.f;
    if (live) {
      float md[LPT], dd[LPT];
      load_lanes(md, oMDN + k0);
      load_lanes(dd, oDDN + k0);
      float c = fmaf(eg, Xw, ea);
#pragma unroll
      for (int j = 0; j < LPT; ++j) {
        D[j] = c;
        c = fmaf(dd[j], c, M[j] * md[j]);
      }
    }
    const float Nn = N * r * xo[X_NN];
    const float Jn = fmaf(E, xo[X_EJC], J * xo[X_JJ]) * r;
    const float Cn = fmaf(E, xo[X_ECC], C * xo[X_CC]) * r;
    B = fmaf(Jn, xo[X_JB], fmaf(Ee, xo[X_EB], Nn * xo[X_NB]));
    N = Nn;
    E = Ee;
    J = Jn;
    C = Cn;
    int ex;
    frexpf(N + B + E + J + C, &ex);
    r = ldexpf(1.f, -ex);
    esum += ex;
    if (kPost && tid == 0)
      *reinterpret_cast<float4*>(Xf + (size_t)(base + p) * kXf) =
          make_float4(N, J, C, r);
  }
  // Q: the last row's total, scaled by its own r
  const float Q = fmaf(E, xo[X_ET], C * xo[X_CT]) * r;
  const float fwd = Q > 0.f ? (float)(log((double)Q) + esum * kLn2) : kNeg;
  if (!kPost) {
    if (tid == 0) out[h] = fwd;
    return;
  }

  // ---- Backward, l = L..1, and the usages ----
  float bM[LPT], bI[LPT], gM[LPT];
#pragma unroll
  for (int j = 0; j < LPT; ++j) bM[j] = bI[j] = gM[j] = 0.f;
  float bN = 0.f, bJ = 0.f, bC = 0.f;
  float gI = 0.f, gN = 0.f, gJ = 0.f, gC = 0.f;
  const float invQ = 1.f / Q;
  float rn = 1.f;  // the scale of position l + 1
  const int wtop = warp * 32 * LPT + 32 * LPT - 1;  // the warp's top lane
  __syncthreads();  // the Forward's last X row is written
  for (int p = L - 1; p >= 0; --p) {  // position l = p + 1
    const int b = p & 1;
    const bool last = p == L - 1;
    const float4 xp =
        *reinterpret_cast<const float4*>(Xf + (size_t)(base + p) * kXf);
    // mb = e bM of position l + 1 (none at l = L), on its scale; the
    // Forward's rows of position l, loaded before the barrier
    float mb[LPT], mf[LPT], jf[LPT];
    float sb = 0.f;
    if (live) {
      float bm[LPT];
      load_lanes(bm, oBM + k0);
#pragma unroll
      for (int j = 0; j < LPT; ++j) {
        mb[j] = last ? 0.f : expf(en[j]) * bM[j] * rn;
        sb = fmaf(bm[j], mb[j], sb);
      }
      if (p > 0) load_lanes(en, emh + (size_t)seq[p] * Kpad + k0);
      const size_t row = (size_t)(base + p) * Kpad + k0;
      load_lanes(mf, Mf + row);
      load_lanes(jf, If + row);
    } else {
#pragma unroll
      for (int j = 0; j < LPT; ++j) mb[j] = 0.f;
    }
    const float mbn = __shfl_down_sync(kFull, mb[0], 1);
    // alpha's pairs composed downward over the thread's lanes, lane 31's
    // top lane left to the warp stage
    float ca = 0.f, cg = live ? 1.f : 0.f;
    if (live) {
      float dm[LPT], dd[LPT];
      load_lanes(dm, oDM + k0);
      load_lanes(dd, oDDN + k0);
#pragma unroll
      for (int j = LPT - 1; j >= 0; --j) {
        if (j == LPT - 1 && lane == 31) continue;
        const float nx = j + 1 < LPT ? mb[j + 1] : mbn;
        ca = fmaf(dd[j], ca, dm[j] * nx);
        cg *= dd[j];
      }
    }
    float ia = ca, ig = cg;
    warp_scan_down(ia, ig, lane);
    float ea = __shfl_down_sync(kFull, ia, 1);
    float eg = __shfl_down_sync(kFull, ig, 1);
    if (lane == 31) {
      ea = 0.f;
      eg = 1.f;
    }
    sb = warp_sum(sb);
    if (lane == 0) {
      s_a[b][warp] = ia;
      s_g[b][warp] = ig;
      s_s[b][warp] = sb;
      s_p[b][warp] = mb[0];
    }
    __syncthreads();  // the position's one barrier
    // warp i: alpha at its bottom = A + G alpha[top], alpha[top] =
    // tdm[top] Y + tdd[top + 1] C, Y the first mb of warp i + 1 and C the
    // alpha past warp i
    float wa = 0.f, wg = 0.f, wb = 0.f;
    if (lane < nwarps) {
      const int top = lane * 32 * LPT + 32 * LPT - 1;
      const bool in = top < Kpad;
      const float Y = lane + 1 < nwarps ? s_p[b][lane + 1] : 0.f;
      const float G = s_g[b][lane];
      wa = fmaf(G * (in ? oDM[top] : 0.f), Y, s_a[b][lane]);
      wg = G * (in ? oDDN[top] : 0.f);
      wb = s_s[b][lane];
    }
    warp_scan_down(wa, wg, lane, nwarps);
    float Cx = __shfl_down_sync(kFull, wa, 1);
    if (lane + 1 >= nwarps) Cx = 0.f;
    const float bB = warp_sum(wb);
    const float Cw = __shfl_sync(kFull, Cx, warp);
    const float Yw = warp + 1 < nwarps ? s_p[b][warp + 1] : 0.f;
    const float end = last ? 1.f : 0.f;
    const float bJn = fmaf(xo[X_JB], bB, xo[X_JJ] * bJ * rn);
    const float bCn = fmaf(end, xo[X_CT], xo[X_CC] * bC * rn);
    const float bE = fmaf(end, xo[X_ET],
                          fmaf(xo[X_EB], bB,
                               fmaf(xo[X_EJC], bJ, xo[X_ECC] * bC) * rn));
    const float bNn = fmaf(xo[X_NB], bB, xo[X_NN] * bN * rn);
    const float cl = xp.w * invQ;  // this position's scale over Q
    if (live) {
      float mm[LPT], im[LPT], dm[LPT], mi[LPT], ii[LPT], md[LPT], dd[LPT],
          be[LPT];
      load_lanes(mm, oMM + k0);
      load_lanes(im, oIM + k0);
      load_lanes(dm, oDM + k0);
      load_lanes(mi, oMI + k0);
      load_lanes(ii, oII + k0);
      load_lanes(md, oMDN + k0);
      load_lanes(dd, oDDN + k0);
      load_lanes(be, oBETAN + k0);
      const bool in = wtop < Kpad;
      const float atop = in ? fmaf(oDM[wtop], Yw, oDDN[wtop] * Cw) : 0.f;
      float c = lane == 31 ? Cw : fmaf(eg, atop, ea);  // alpha past lane j
      const float mbt = lane == 31 ? Yw : mbn;
#pragma unroll
      for (int j = LPT - 1; j >= 0; --j) {
        const float nx = j + 1 < LPT ? mb[j + 1] : mbt;
        const float bD1 = fmaf(be[j], bE, c);  // bD[k + 1]
        const float bi = bI[j] * rn;
        const float nM =
            fmaf(md[j], bD1, fmaf(mi[j], bi, fmaf(mm[j], nx, bE)));
        const float nI = fmaf(ii[j], bi, im[j] * nx);
        bM[j] = nM;
        bI[j] = nI;
        gM[j] = fmaf(mf[j] * nM, cl, gM[j]);
        gI = fmaf(jf[j] * nI, cl, gI);
        c = fmaf(dd[j], c, dm[j] * nx);
      }
    }
    bN = bNn;
    bJ = bJn;
    bC = bCn;
    rn = xp.w;
    if (tid == 0) {
      gN = fmaf(xp.x * bN, cl, gN);
      gJ = fmaf(xp.y * bJ, cl, gJ);
      gC = fmaf(xp.z * bC, cl, gC);
    }
  }
  float* o = out + (size_t)h * (3 + Kpad);
  if (live) {
#pragma unroll
    for (int j = 0; j < LPT; ++j) o[3 + k0 + j] = gM[j];  // 4-byte aligned
  }
  gI = warp_sum(gI);
  __syncthreads();  // the last position's reads of the slots are done
  if (lane == 0) s_s[0][warp] = gI;
  __syncthreads();
  if (tid == 0) {
    float s = 0.f;
    for (int w = 0; w < nwarps; ++w) s += s_s[0][w];
    o[0] = fwd;
    o[1] = s;
    o[2] = (gN + gJ) + gC;
  }
}

template <int LPT, int kMaxThreads, bool kPost>
int launch(int H, int Kpad, const void* em, const void* tv, const void* res,
           const void* off, const void* xv, void* odds, void* out, void* Mf,
           void* If, void* Xf, void* stream) {
  const int threads = Kpad / LPT < 32 ? 32 : Kpad / LPT;
  const int smem = Kpad <= kSmemMaxKp ? kOdds * Kpad * 4 : 0;
  cudaError_t err = cudaFuncSetAttribute(
      amino_kernel<LPT, kMaxThreads, kPost>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  if (H > 0)
    amino_kernel<LPT, kMaxThreads, kPost>
        <<<H, threads, smem, (cudaStream_t)stream>>>(
        (const float*)em, (const float*)tv, (const int*)res, (const int*)off,
        (const float*)xv, Kpad, (float*)odds, (float*)out, (float*)Mf,
        (float*)If, (float*)Xf);
  return (int)cudaGetLastError();
}

template <bool kPost>
int dispatch(int H, int Kpad, const void* em, const void* tv,
             const void* res, const void* off, const void* xv, void* odds,
             void* out, void* Mf, void* If, void* Xf, void* stream) {
  // Kpad: a power of two from 16 to kMaxKp (forward.py _pad_pow2); every
  // lane row on 16 bytes; the odds scratch past kSmemMaxKp
  if (Kpad < 16 || Kpad > kMaxKp || (Kpad & (Kpad - 1)) ||
      ((size_t)em | (size_t)tv | (size_t)odds | (size_t)Mf | (size_t)If |
       (size_t)Xf) % 16 ||
      (Kpad > kSmemMaxKp && !odds))
    return (int)cudaErrorInvalidValue;
  // at most 512 threads up to Kpad 4096 (128 registers a thread), 1024
  // past it
  if (Kpad <= 2048)
    return launch<4, 512, kPost>(H, Kpad, em, tv, res, off, xv, odds, out,
                                 Mf, If, Xf, stream);
  if (Kpad <= 4096)
    return launch<8, 512, kPost>(H, Kpad, em, tv, res, off, xv, odds, out,
                                 Mf, If, Xf, stream);
  if (Kpad <= 8192)
    return launch<8, 1024, kPost>(H, Kpad, em, tv, res, off, xv, odds, out,
                                  Mf, If, Xf, stream);
  return launch<16, 1024, kPost>(H, Kpad, em, tv, res, off, xv, odds, out,
                                 Mf, If, Xf, stream);
}

}  // namespace

// HMMER3 local multihit Forward of H hits: out (H,) nats.  `odds`: a
// scratch of H x 9 x Kpad f32 past Kpad 4096 (may be null up to it).
extern "C" int dtt_amino_forward(const void* em, const void* tv,
                                 const void* res, const void* off,
                                 const void* xv, void* odds, void* out, int H,
                                 int Kpad, void* stream) {
  return dispatch<false>(H, Kpad, em, tv, res, off, xv, odds, out, nullptr,
                         nullptr, nullptr, stream);
}

// Forward + Backward usages of H hits: out (H, 3 + Kpad) = (fwd, gI, gNCJ,
// gM), with the Forward rows in Mf, If (N, Kpad) and X (N, 4); `odds` as
// the Forward's.
extern "C" int dtt_amino_posterior(const void* em, const void* tv,
                                   const void* res, const void* off,
                                   const void* xv, void* odds, void* out,
                                   void* Mf, void* If, void* Xf, int H,
                                   int Kpad, void* stream) {
  return dispatch<true>(H, Kpad, em, tv, res, off, xv, odds, out, Mf, If, Xf,
                        stream);
}
