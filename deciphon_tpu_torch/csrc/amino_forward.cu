// Amino Forward and posterior kernels: the HMMER3 local multihit Forward of
// an amino sequence against one profile (nats), and Forward + Backward
// posterior state usages for the null2 bias; one CTA a hit.
//
// Replaces deciphon_tpu/hmmer/forward.py `_jit_forward` (a lax.scan over
// the amino positions: log-sum-exp over M, I and D, the D chain as an
// associative log-add scan, the N, B, E, J and C specials) and
// `_jit_posterior` (that Forward, then Backward, then the usages gM (Kpad,),
// gI and gNCJ).  Both are XLA, not Pallas.
//
// Arithmetic.  The reference's, op for op, in f32: logaddexp as
// max + log1p(exp(-|a - b|)), the sentinel _NEG = -1e30 on pad lanes (not
// -inf: -inf - -inf is NaN), the pad tdd at _NEG / Kpad, the Backward's
// zeroed pad multipliers and dvalid mask.  The sums of exponentials and the
// two log-add scans run in another order than XLA's trees, and log-add in
// f32 is not associative, so results agree with the reference (and with
// the plain versions in hmmer/forward.py) within a tolerance, not bit for
// bit.  Built without fast math: expf and log1pf are the precise ones.
// Threads past Kpad hold -inf, the identity of every reduction here.
//
// What bounds it.  A (position, node) cell takes 14 transcendentals in the
// Forward (7 logaddexps of an exp and a log1p each, counting the scan's
// two, and the two exps of E's sums) and 17 more in the Backward.  One
// H100 SM issues 16 MUFU operations a clock: a CTA's Forward needs at
// least 14 Kpad / 16 clocks a position (1792 at Kpad 2048, 0.9 us at 1.98
// GHz) and the posterior 31 Kpad / 16.  Against that stands the position
// chain, which no lane count shortens: a precise logaddexp is a dependent
// chain of some 200 clocks, and a position strings together the
// thread's own lanes, a warp-shuffle log-add scan or reduction on each
// side of each of two barriers (5 dependent steps) and the specials.
// Measured on one H100 80GB HBM3 at 700 W (chip_smoke.py phase 8, PERF.md
// section 6): the Forward 5.9-7.9 us a position from Kpad 16 to 2048, the
// posterior 11.6-15.6 us, so the chain bounds it, not the MUFU rate.
// Over the whole card (132 SMs) the MUFU bound is two orders lower still;
// one hit a launch uses one SM (batching a wave's hits over CTAs is the
// next step).
//
// Design.  One CTA a hit; the grid takes a batch of hits (per-hit offsets
// into the residues, per-hit tables of one Kpad).  Thread t owns LPT
// consecutive lanes k (LPT 4 up to Kpad 2048, 8 up to 8192, 16 at 16384;
// Kpad / LPT threads, at least one warp: at most 512 threads, so 128
// registers a thread, up to Kpad 4096) and keeps their M, I and D
// (Backward: bM, bI and the gM sums) in registers.  The transition
// vectors sit in shared memory up to Kpad 4096 (11 x Kpad x 4 B) and are
// read through L2 past it.  A Forward position:
//   * Mrow and Irow from the previous row: the neighbour lane's
//     lse(M + tmm, I + tim, D + tdm) by __shfl_up_sync and, across warps,
//     from a slot each warp's last lane wrote in the previous position;
//   * the D chain: P = log-add prefix of G = shift(Mrow) + tmd - S, taken
//     as G[0] and the exclusive prefix of Mrow[k] + tmd[k+1] - S[k+1] (no
//     neighbour exchange): the thread's own prefixes, a warp shuffle
//     scan, barrier 1, every warp scans the warps' totals (log2 of the
//     warp count rounds), and each lane takes the carry in one logaddexp;
//   * E = lse(logsumexp(Mrow), logsumexp(Drow)) from warp maxima and sums,
//     Mrow's published before barrier 1 and Drow's before barrier 2;
//   * the specials, computed by every thread from the same shared partials
//     (the same bits everywhere, so no broadcast round).
// The Backward runs l = L..1 in the same two rounds: bB's logsumexp before
// barrier 1, the reversed log-add suffix scan for bD before barrier 2 (bD
// is needed only as the neighbour's bD[k+1], the exclusive suffix past
// lane k, which the thread has: no third round).  It reads the Forward's M and I rows, and N, J and C, from a
// global scratch of (8 Kpad + 12) L bytes that the posterior's Forward
// wrote; the reads and writes of a lane are the same thread's.
#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr unsigned kFull = 0xffffffffu;
constexpr float kNeg = -1e30f;  // forward.py _NEG
constexpr int kRows = 21;       // odds-table rows: 20 aminos, degenerate
// rows of the transition-vector table tv (hmmer/forward.py TV_*)
enum { TV_MM, TV_IM, TV_DM, TV_MI, TV_II, TV_MD, TV_DD, TV_BM, TV_DV, TV_S,
       TV_SREV, kTvRows };
// the special-state scores of a hit (hmmer/forward.py X_*)
enum { X_NN, X_NB, X_EJC, X_JJ, X_JB, X_EB, X_ECC, X_CC, X_ET, X_CT, kXv };
constexpr int kSmemMaxKp = 4096;  // tv in shared memory up to this Kpad
constexpr int kMaxKp = 16384;

__device__ __forceinline__ float lae(float a, float b) {
  const float m = fmaxf(a, b);
  if (m == -INFINITY) return m;  // identity lanes only
  return m + log1pf(expf(-fabsf(a - b)));
}

// Warp max of x over the thread's live lanes, then the warp sum of
// exp(x - max); every lane gets both (butterflies of commutative ops).
template <int LPT>
__device__ __forceinline__ void warp_lse_part(const float (&x)[LPT],
                                              bool live, float& wm,
                                              float& ws) {
  float m = -INFINITY;
  if (live) {
#pragma unroll
    for (int j = 0; j < LPT; ++j) m = fmaxf(m, x[j]);
  }
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) m = fmaxf(m, __shfl_xor_sync(kFull, m, o));
  float s = 0.f;
  if (live) {
#pragma unroll
    for (int j = 0; j < LPT; ++j) s += expf(x[j] - m);
  }
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) s += __shfl_xor_sync(kFull, s, o);
  wm = m;
  ws = s;
}

// logsumexp over the warps' partials (max, sum); every thread of every
// warp computes the same bits.
__device__ __forceinline__ float block_lse(const float* pm, const float* ps,
                                          int nwarps, int lane) {
  float m = lane < nwarps ? pm[lane] : -INFINITY;
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) m = fmaxf(m, __shfl_xor_sync(kFull, m, o));
  float s = lane < nwarps ? ps[lane] * expf(pm[lane] - m) : 0.f;
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) s += __shfl_xor_sync(kFull, s, o);
  return logf(s) + m;
}

// Inclusive log-add scan over the first n lanes of a warp, upward
// (prefix) or downward (suffix); n is the same in every lane.
__device__ __forceinline__ float warp_scan_up(float v, int lane, int n = 32) {
#pragma unroll
  for (int o = 1; o < n; o <<= 1) {
    const float u = __shfl_up_sync(kFull, v, o);
    if (lane >= o) v = lae(u, v);
  }
  return v;
}

__device__ __forceinline__ float warp_scan_down(float v, int lane,
                                                int n = 32) {
#pragma unroll
  for (int o = 1; o < n; o <<= 1) {
    const float u = __shfl_down_sync(kFull, v, o);
    if (lane + o < 32) v = lae(v, u);
  }
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

// One CTA a hit h: residues res[off[h] .. off[h+1]), odds table
// em (H, 21, Kpad), vectors tv (H, 11, Kpad), specials xv (H, 10).
// kPost = false: out[h] = forward nats.  kPost = true: out (H, 3 + Kpad) =
// (fwd, gI, gNCJ, gM...), with the scratch Mf, If (N, Kpad) and X (N, 3).
template <int LPT, int kMaxThreads, bool kPost>
__global__ void __launch_bounds__(kMaxThreads)
    amino_kernel(const float* __restrict__ em, const float* __restrict__ tv,
                 const int* __restrict__ res, const int* __restrict__ off,
                 const float* __restrict__ xv, int Kpad, int smem_tv,
                 float* __restrict__ out, float* __restrict__ Mf,
                 float* __restrict__ If, float* __restrict__ Xf) {
  extern __shared__ float4 s_dyn[];
  __shared__ float s_tot[32], s_pm[32], s_ps[32], s_dm[32], s_ds[32],
      s_pub[32];
  const int h = blockIdx.x;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int nwarps = blockDim.x >> 5;
  const int k0 = tid * LPT;
  const bool live = k0 < Kpad;
  const bool top = k0 + LPT == Kpad;  // owns the last lane, Kpad - 1
  const int base = off[h];
  const int L = off[h + 1] - base;
  const int* seq = res + base;
  const float* emh = em + (size_t)h * kRows * Kpad;
  const float* T = tv + (size_t)h * kTvRows * Kpad;
  if (smem_tv) {
    const float4* src = reinterpret_cast<const float4*>(T);
    for (int i = tid; i < kTvRows * Kpad / 4; i += blockDim.x)
      s_dyn[i] = src[i];
    T = reinterpret_cast<const float*>(s_dyn);
    __syncthreads();
  }
  const float* tmm = T + TV_MM * Kpad;
  const float* tim = T + TV_IM * Kpad;
  const float* tdm = T + TV_DM * Kpad;
  const float* tmi = T + TV_MI * Kpad;
  const float* tii = T + TV_II * Kpad;
  const float* tmd = T + TV_MD * Kpad;
  const float* tbm = T + TV_BM * Kpad;
  const float* tdv = T + TV_DV * Kpad;
  const float* tS = T + TV_S * Kpad;
  const float* tSr = T + TV_SREV * Kpad;
  float x[kXv];
#pragma unroll
  for (int i = 0; i < kXv; ++i) x[i] = xv[h * kXv + i];
  const float ninit = live ? kNeg : -INFINITY;

  // ---- Forward ----
  float M[LPT], I[LPT], D[LPT];
#pragma unroll
  for (int j = 0; j < LPT; ++j) M[j] = I[j] = D[j] = ninit;
  float N = 0.f, B = 0.f + x[X_NB], E = kNeg, J = kNeg, C = kNeg;
  // G[0] = (shift(Mrow)[0] + tmd[0]) - S[0]: the prefix's first term
  const float G0 = (kNeg + tmd[0]) - tS[0];
  // a warp's last lane publishes lse(M + tmm, I + tim, D + tdm) of its
  // last lane for the next position's Mrow in the warp above
  if (lane == 31 && live) {
    const int k = k0 + LPT - 1;
    s_pub[warp] = lae(lae(M[LPT - 1] + tmm[k], I[LPT - 1] + tim[k]),
                      D[LPT - 1] + tdm[k]);
  }
  __syncthreads();
  for (int p = 0; p < L; ++p) {
    float e[LPT], inn[LPT], Y[LPT];
    if (live) {
      load_lanes(e, emh + (size_t)seq[p] * Kpad + k0);
#pragma unroll
      for (int j = 0; j < LPT; ++j) {
        const int k = k0 + j;
        inn[j] = lae(lae(M[j] + tmm[k], I[j] + tim[k]), D[j] + tdm[k]);
      }
    } else {
#pragma unroll
      for (int j = 0; j < LPT; ++j) inn[j] = -INFINITY;
    }
    float up = __shfl_up_sync(kFull, inn[LPT - 1], 1);
    if (lane == 0) up = warp ? s_pub[warp - 1] : kNeg;  // shift pads _NEG
    // pre[j]: the log-add of Y over the thread's lanes before j; t: all
    float pre[LPT], t = -INFINITY;
    if (live) {
#pragma unroll
      for (int j = 0; j < LPT; ++j) {
        const int k = k0 + j;
        const float mi = lae(M[j] + tmi[k], I[j] + tii[k]);
        M[j] = e[j] + lae(j ? inn[j - 1] : up, B + tbm[k]);
        I[j] = mi;
        Y[j] = k + 1 < Kpad ? (M[j] + tmd[k + 1]) - tS[k + 1] : -INFINITY;
        pre[j] = t;
        t = lae(t, Y[j]);
      }
    } else {
#pragma unroll
      for (int j = 0; j < LPT; ++j) Y[j] = pre[j] = -INFINITY;
    }
    const float incl = warp_scan_up(t, lane);
    float excl = __shfl_up_sync(kFull, incl, 1);
    if (lane == 0) excl = -INFINITY;
    if (lane == 31) s_tot[warp] = incl;
    float wm, ws;
    warp_lse_part(M, live, wm, ws);
    if (lane == 0) {
      s_pm[warp] = wm;
      s_ps[warp] = ws;
    }
    __syncthreads();  // barrier 1: scan totals, Mrow's partials
    const float lseM = block_lse(s_pm, s_ps, nwarps, lane);
    const float wt = warp_scan_up(lane < nwarps ? s_tot[lane] : -INFINITY,
                                  lane, nwarps);
    float wpre = __shfl_sync(kFull, wt, warp ? warp - 1 : 0);
    if (warp == 0) wpre = -INFINITY;
    const float carry = lae(lae(G0, wpre), excl);  // lanes before k0
    if (live) {
#pragma unroll
      for (int j = 0; j < LPT; ++j) D[j] = lae(carry, pre[j]) + tS[k0 + j];
    }
    warp_lse_part(D, live, wm, ws);
    if (lane == 0) {
      s_dm[warp] = wm;
      s_ds[warp] = ws;
    }
    if (lane == 31 && live) {
      const int k = k0 + LPT - 1;
      s_pub[warp] = lae(lae(M[LPT - 1] + tmm[k], I[LPT - 1] + tim[k]),
                        D[LPT - 1] + tdm[k]);
    }
    if (kPost && live) {
      store_lanes(Mf + (size_t)(base + p) * Kpad + k0, M);
      store_lanes(If + (size_t)(base + p) * Kpad + k0, I);
    }
    __syncthreads();  // barrier 2: Drow's partials, the published inner
    const float Ee = lae(lseM, block_lse(s_dm, s_ds, nwarps, lane));
    const float Nn = N + x[X_NN];
    const float Jn = lae(E + x[X_EJC], J + x[X_JJ]);
    const float Cn = lae(E + x[X_ECC], C + x[X_CC]);
    B = lae(lae(Nn + x[X_NB], Ee + x[X_EB]), Jn + x[X_JB]);
    N = Nn;
    E = Ee;
    J = Jn;
    C = Cn;
    if (kPost && tid == 0) {
      float* xf = Xf + (size_t)(base + p) * 3;
      xf[0] = N;
      xf[1] = J;
      xf[2] = C;
    }
  }
  const float fwd = lae(E + x[X_ET], C + x[X_CT]);
  if (!kPost) {
    if (tid == 0) out[h] = fwd;
    return;
  }

  // ---- Backward, l = L..1, and the usages ----
  float bM[LPT], bI[LPT], gM[LPT];
#pragma unroll
  for (int j = 0; j < LPT; ++j) {
    bM[j] = bI[j] = ninit;
    gM[j] = 0.f;
  }
  float bN = kNeg, bJ = kNeg, bC = kNeg;
  float gI = 0.f, gN = 0.f, gJ = 0.f, gC = 0.f;
  for (int p = L - 1; p >= 0; --p) {  // position l = p + 1
    const bool last = p == L - 1;
    float mb[LPT], z[LPT];
    if (live) {
      if (last) {  // no position l + 1: its emission row is _NEG
#pragma unroll
        for (int j = 0; j < LPT; ++j) mb[j] = kNeg + bM[j];
      } else {
        load_lanes(mb, emh + (size_t)seq[p + 1] * Kpad + k0);
#pragma unroll
        for (int j = 0; j < LPT; ++j) mb[j] += bM[j];
      }
#pragma unroll
      for (int j = 0; j < LPT; ++j) z[j] = tbm[k0 + j] + mb[j];
    } else {
#pragma unroll
      for (int j = 0; j < LPT; ++j) mb[j] = z[j] = -INFINITY;
    }
    if (lane == 0) s_pub[warp] = mb[0];
    float wm, ws;
    warp_lse_part(z, live, wm, ws);
    if (lane == 0) {
      s_pm[warp] = wm;
      s_ps[warp] = ws;
    }
    __syncthreads();  // barrier 1: bB's partials, the published mb
    const float bB = block_lse(s_pm, s_ps, nwarps, lane);
    // mb[k + 1] of the thread's last lane; shift_back pads _NEG
    float mbn = __shfl_down_sync(kFull, mb[0], 1);
    if (lane == 31) mbn = warp + 1 < nwarps ? s_pub[warp + 1] : kNeg;
    if (top) mbn = kNeg;
    const float end = last ? 0.f : kNeg;
    const float bJn = lae(x[X_JB] + bB, x[X_JJ] + bJ);
    const float bCn = lae(end + x[X_CT], x[X_CC] + bC);
    const float bE = lae(lae(lae(end + x[X_ET], x[X_EB] + bB),
                             x[X_EJC] + bJ), x[X_ECC] + bC);
    const float bNn = lae(x[X_NB] + bB, x[X_NN] + bN);
    // suf[j]: the log-add of z = R - Srev over the thread's lanes after
    // j; t: all
    float suf[LPT], t = -INFINITY;
    if (live) {
#pragma unroll
      for (int j = LPT - 1; j >= 0; --j) {
        const int k = k0 + j;
        const float nx = j + 1 < LPT ? mb[j + 1] : mbn;
        float R = lae(bE, tdm[k] + nx);
        R = tdv[k] > 0.f ? R : kNeg;
        z[j] = R - tSr[k];
        suf[j] = t;
        t = lae(z[j], t);
      }
    }
    const float incl = warp_scan_down(t, lane);
    float excl = __shfl_down_sync(kFull, incl, 1);
    if (lane == 31) excl = -INFINITY;
    if (lane == 0) s_tot[warp] = incl;
    __syncthreads();  // barrier 2: the suffix scan's warp totals
    const float wt = warp_scan_down(lane < nwarps ? s_tot[lane] : -INFINITY,
                                    lane, nwarps);
    float wsuf = __shfl_sync(kFull, wt, warp < 31 ? warp + 1 : 31);
    if (warp + 1 >= nwarps) wsuf = -INFINITY;
    const float carry = lae(wsuf, excl);  // the lanes past the thread's
    if (live) {
      const size_t row = (size_t)(base + p) * Kpad + k0;
      float mf[LPT], jf[LPT];
      load_lanes(mf, Mf + row);
      load_lanes(jf, If + row);
#pragma unroll
      for (int j = LPT - 1; j >= 0; --j) {
        const int k = k0 + j;
        const float nx = j + 1 < LPT ? mb[j + 1] : mbn;
        // shift_back(tmd + bD)[k], bD[k + 1] = Prev[k + 1] + Srev[k + 1],
        // Prev[k + 1] the log-add of z past lane k
        const float dn = k + 1 < Kpad
            ? tmd[k + 1] + (lae(suf[j], carry) + tSr[k + 1]) : kNeg;
        const float nM = lae(lae(lae(bE, tmm[k] + nx), tmi[k] + bI[j]), dn);
        const float nI = lae(tim[k] + nx, tii[k] + bI[j]);
        bM[j] = nM;
        bI[j] = nI;
        gM[j] += expf((mf[j] + nM) - fwd);
        gI += expf((jf[j] + nI) - fwd);
      }
    }
    bN = bNn;
    bJ = bJn;
    bC = bCn;
    if (tid == 0) {
      const float* xf = Xf + (size_t)(base + p) * 3;
      gN += expf((xf[0] + bN) - fwd);
      gJ += expf((xf[1] + bJ) - fwd);
      gC += expf((xf[2] + bC) - fwd);
    }
  }
  float* o = out + (size_t)h * (3 + Kpad);
  if (live) {
#pragma unroll
    for (int j = 0; j < LPT; ++j) o[3 + k0 + j] = gM[j];
  }
#pragma unroll
  for (int q = 16; q > 0; q >>= 1) gI += __shfl_xor_sync(kFull, gI, q);
  __syncthreads();  // the last position's reads of s_tot are done
  if (lane == 0) s_tot[warp] = gI;
  __syncthreads();
  if (tid == 0) {
    float s = 0.f;
    for (int w = 0; w < nwarps; ++w) s += s_tot[w];
    o[0] = fwd;
    o[1] = s;
    o[2] = (gN + gJ) + gC;
  }
}

template <int LPT, int kMaxThreads, bool kPost>
int launch(int H, int Kpad, const void* em, const void* tv, const void* res,
           const void* off, const void* xv, void* out, void* Mf, void* If,
           void* Xf, void* stream) {
  const int threads = Kpad / LPT < 32 ? 32 : Kpad / LPT;
  const int smem_tv = Kpad <= kSmemMaxKp;
  const int smem = smem_tv ? kTvRows * Kpad * 4 : 0;
  cudaError_t err = cudaFuncSetAttribute(
      amino_kernel<LPT, kMaxThreads, kPost>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  if (H > 0)
    amino_kernel<LPT, kMaxThreads, kPost>
        <<<H, threads, smem, (cudaStream_t)stream>>>(
        (const float*)em, (const float*)tv, (const int*)res, (const int*)off,
        (const float*)xv, Kpad, smem_tv, (float*)out, (float*)Mf, (float*)If,
        (float*)Xf);
  return (int)cudaGetLastError();
}

template <bool kPost>
int dispatch(int H, int Kpad, const void* em, const void* tv,
             const void* res, const void* off, const void* xv, void* out,
             void* Mf, void* If, void* Xf, void* stream) {
  // Kpad: a power of two from 16 to kMaxKp (forward.py _pad_pow2); every
  // lane row on 16 bytes
  if (Kpad < 16 || Kpad > kMaxKp || (Kpad & (Kpad - 1)) ||
      ((size_t)em | (size_t)tv | (size_t)Mf | (size_t)If) % 16)
    return (int)cudaErrorInvalidValue;
  // at most 512 threads up to Kpad 4096 (128 registers a thread), 1024
  // past it
  if (Kpad <= 2048)
    return launch<4, 512, kPost>(H, Kpad, em, tv, res, off, xv, out, Mf, If,
                                 Xf, stream);
  if (Kpad <= 4096)
    return launch<8, 512, kPost>(H, Kpad, em, tv, res, off, xv, out, Mf, If,
                                 Xf, stream);
  if (Kpad <= 8192)
    return launch<8, 1024, kPost>(H, Kpad, em, tv, res, off, xv, out, Mf, If,
                                  Xf, stream);
  return launch<16, 1024, kPost>(H, Kpad, em, tv, res, off, xv, out, Mf, If,
                                 Xf, stream);
}

}  // namespace

// HMMER3 local multihit Forward of H hits: out (H,) nats.
extern "C" int dtt_amino_forward(const void* em, const void* tv,
                                 const void* res, const void* off,
                                 const void* xv, void* out, int H, int Kpad,
                                 void* stream) {
  return dispatch<false>(H, Kpad, em, tv, res, off, xv, out, nullptr, nullptr,
                         nullptr, stream);
}

// Forward + Backward usages of H hits: out (H, 3 + Kpad) = (fwd, gI, gNCJ,
// gM), with the Forward rows in Mf, If (N, Kpad) and X (N, 3).
extern "C" int dtt_amino_posterior(const void* em, const void* tv,
                                   const void* res, const void* off,
                                   const void* xv, void* out, void* Mf,
                                   void* If, void* Xf, int H, int Kpad,
                                   void* stream) {
  return dispatch<true>(H, Kpad, em, tv, res, off, xv, out, Mf, If, Xf,
                        stream);
}
