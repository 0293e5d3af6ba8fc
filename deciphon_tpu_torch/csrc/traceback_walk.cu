// Device traceback walk: T back to S over the packed trellis, one warp per
// survivor.
//
// Replaces deciphon_tpu/ops/traceback.py `_unzip_one` / `_unzip_batch_jit`
// (a vmapped jax while_loop).  Each CTA walks the device-resident trellis
// rows of one survivor: xnode (R, Lk) and node (R, Lk, Kp) int32 as the
// path kernel wrote them, selected by `rows` without a copy.  Stage s
// reads row s-1; stage 0 is the all-zero row the reference pads in.  The
// walk emits states (uint16 bits, stored as int16) and sizes (int8) in
// REVERSE order (T first), excluding the final (S, 0) step, plus the step
// count and an ok flag; a walk that overflows max_steps (Lk + 4*Kp + 64 on
// the scan's first try) or underflows its stage reports ok = 0, and the
// caller walks the overflowed ones again with more steps
// (ops/traceback.py rewalk).
//
// What bounds it.  A step is a dependent pair of loads: the next word's
// address is the step's result, so a walk is a chain of latencies, and the
// trellis B2 has just written is far larger than L2 (82 MB a window at Kp
// 2048 x 10 knt).  One thread a survivor paid an L2 or HBM latency a step
// (about 300 ns), and a launch's few survivors shared one warp and took
// turns on one SM.  Here a step's latency is its own instruction chain
// on shared memory, so the step logic is kept short: on one H100 80GB HBM3
// at 700.00 W, about 125 ns a step in N/C/J runs and 200 ns inside a
// domain (PERF.md section 6).
//
// Design.  One CTA of one warp a survivor (grid B), so walks neither
// diverge nor share an SM.  The warp stays converged: every lane runs the
// step logic (the reference's fields, order, max_steps, overflow and
// underflow rules, unchanged) on broadcast reads of shared memory and
// stores the same step, so no branch diverges and a refill needs no
// hand-over.  A special state reads only its xnode word, a
// core state only its node word, so the warp keeps two buffers of each in
// shared memory and fills them with cp.async (16-byte copies where Kp and
// Lk allow it), in the walker's registers the bounds of all four:
//   * xnode: chunks of kXWords words ending at a stage, the one below
//     copied while the walker reads the current one (xnode words are
//     contiguous in stage and the walk only goes down);
//   * node: tiles of rows [stage - kTileRows, stage) and columns
//     [k - kTileCols, k] (clamped), each row segment one coalesced load;
//     inside a domain a step lowers k by at most one and the stage by at
//     most five, so a tile serves many steps.  While the walker reads one
//     tile, the neighbour below and to the left (overlapping the lower
//     half and the left half) is copied into the other; a step outside
//     both (E's jump, a long D or I run) refills the tile at the walker.
// Runs of N, C or J steps and of M <- M steps take tight loops (the same
// fields and rules, fewer branches); every other step, and a step that
// leaves its buffer, takes the general one.  The steps go to a shared
// buffer and out as coalesced chunks.  Rows at or past a window's length
// were never written by B2: a node tile ends at the walker's row, and an
// xnode chunk at most three words past it (its last 16-byte copy), which
// the walker, going down, never uses.
#include "common.cuh"

namespace {

constexpr int S_ = 0xC003, N_ = 0xC004, B_ = 0xC005, E_ = 0xC006,
              J_ = 0xC007, C_ = 0xC008, T_ = 0xC009;
constexpr int CLS_M = 0, CLS_I = 1, CLS_D = 2;

// Node tile rows and columns, and xnode words a chunk.  Chosen from the
// walk launches of the Pfam, long-read and large-K scans on one H100 80GB
// HBM3 at 700.00 W, all tiles in one call (PERF.md section 6): the
// Pfam scan's 18 launches took 6.73 ms in all at 96 x 32 (64 x 32 6.90,
// 128 x 32 6.78, 128 x 64 6.86), the long read's 8.35 (8.48, 8.42, 8.57)
// and the large-K scan's 3 launches 4.02 (4.19, 4.06, 4.38); in an
// earlier form of the loop 32 x 16 was 2-6% slower than 96 x 32 and 192 x
// 64 1-6% slower.
constexpr int kTileRows = 96;
constexpr int kTileCols = 32;
constexpr int kXWords = 1024;
constexpr int kOutSteps = 1024;  // steps buffered before a write
constexpr int kTileWords = kTileRows * kTileCols;
constexpr size_t kWalkSmem = 2 * kTileWords * sizeof(int);

__device__ __forceinline__ int bits(int v, int off, int width) {
  return (v >> off) & ((1 << width) - 1);
}

__device__ __forceinline__ int mk(int cls, int k) { return (cls << 14) | (k + 1); }

__device__ __forceinline__ void cp4(int* dst, const int* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(
                   (unsigned)__cvta_generic_to_shared(dst)),
               "l"(src));
}

__device__ __forceinline__ void cp16(int* dst, const int* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(
                   (unsigned)__cvta_generic_to_shared(dst)),
               "l"(src));
}

// Rows [r0, r1) and columns [c0, c1) of a buffer, and where it starts in
// shared memory (an xnode chunk holds words r0..r1-1 in one column); empty
// when r0 == r1.  Kept in registers: the walker reads them every step.
struct Span {
  int r0, r1, c0, c1, at;
};

// The warp copies rows [s.r0, s.r1) x columns [s.c0, s.c1) of a row-major
// plane of `pitch` words to smem + s.at (row stride `stride`), consecutive
// lanes on consecutive words; vec: 16-byte copies (s.c0, s.c1, pitch and
// the bases multiples of 4 words).  Committed, not waited for.
__device__ __noinline__ void copy_span(int* smem, int stride,
                                       const int* src, int pitch, Span s,
                                       bool vec) {
  const int lane = threadIdx.x;
  const int nr = s.r1 - s.r0;
  const int q = vec ? (s.c1 - s.c0) >> 2 : s.c1 - s.c0;  // copies a row
  if (q > 0 && 32 % q == 0) {  // 32 / q rows a round, no division a copy
    const int rr = 32 / q, c = lane % q;
    const int w = vec ? 4 * c : c;
    const int* from = src + (size_t)(s.r0 + lane / q) * pitch + s.c0 + w;
    int* to = smem + s.at + (lane / q) * stride + w;
    for (int r = lane / q; r < nr; r += rr) {
      if (vec)
        cp16(to, from);
      else
        cp4(to, from);
      from += (size_t)rr * pitch;
      to += rr * stride;
    }
  } else {
    for (int j = lane; j < nr * q; j += 32) {
      const int r = j / q, c = j - r * q;
      const int* from = src + (size_t)(s.r0 + r) * pitch + s.c0;
      if (vec)
        cp16(smem + s.at + r * stride + 4 * c, from + 4 * c);
      else
        cp4(smem + s.at + r * stride + c, from + c);
    }
  }
  dtt::cp_async_commit();
}

// The buffer ending at (row, col), at `at`: rows [row + 1 - rows, row],
// columns [col + 1 - cols, col] clamped at 0, widened on the high side to
// whole 16-byte copies (within `width`) when vec.
__device__ __forceinline__ Span ending_at(int row, int col, int rows,
                                          int cols, int width, bool vec,
                                          int at) {
  Span s;
  s.r1 = row + 1;
  s.r0 = max(0, s.r1 - rows);
  s.c1 = vec ? min(width, (col & ~3) + 4) : col + 1;
  s.c0 = max(0, s.c1 - cols);
  s.at = at;
  return s;
}

// The xnode chunk of words [w0, w1) ending at word r: rows w0..w1-1 of
// one column, copied as one row of w1 - w0 columns.
__device__ __forceinline__ Span xchunk(int r, int Lk, bool vec, int at) {
  const Span w = ending_at(0, r, 1, kXWords, Lk, vec, at);
  return Span{w.c0, w.c1, 0, 1, at};
}

__device__ __forceinline__ void copy_xchunk(int* smem, const int* x,
                                            Span s, bool vec) {
  copy_span(smem, 0, x, 0, Span{0, 1, s.r0, s.r1, s.at}, vec);
}

__device__ __forceinline__ bool holds(const Span& s, int r, int c) {
  return r >= s.r0 && r < s.r1 && c >= s.c0 && c < s.c1;
}

__device__ __forceinline__ void swap_spans(Span& a, Span& b) {
  const Span t = a;
  a = b;
  b = t;
}

// wait for every copy in flight, and see the other lanes' copies
__device__ __forceinline__ void land() {
  dtt::cp_async_wait();
  __syncwarp();
}

__global__ void __launch_bounds__(32) walk_kernel(
    const int* __restrict__ xn, const int* __restrict__ nd,
    const int* __restrict__ rows, const int* __restrict__ lens,
    short* __restrict__ sts, signed char* __restrict__ szs,
    int* __restrict__ ns, unsigned char* __restrict__ oks, int Lk, int Kp,
    int max_steps, int vec_nd, int vec_xn) {
  extern __shared__ int4 dyn[];
  int* tiles = reinterpret_cast<int*>(dyn);  // two node tiles
  __shared__ __align__(16) int xbuf[2 * kXWords];  // two xnode chunks
  __shared__ short sbuf[kOutSteps];
  __shared__ signed char zbuf[kOutSteps];
  const int b = blockIdx.x, lane = threadIdx.x;
  const int row = rows[b];
  const int* x = xn + (size_t)row * Lk;
  const int* nodes = nd + (size_t)row * Lk * Kp;
  short* so = sts + (size_t)b * max_steps;
  signed char* zo = szs + (size_t)b * max_steps;
  // the tile and the chunk the walker reads, and the ones held or in
  // flight beside them
  Span t = {0, 0, 0, 0, 0}, u = {0, 0, 0, 0, kTileWords};
  Span xc = {0, 0, 0, 0, 0}, xo = {0, 0, 0, 0, kXWords};

  // Every lane runs each step on the same values (broadcast reads), so
  // every branch is uniform and the warp never diverges.
  int state = T_, stage = lens[b], n = 0, n0 = 0;
  bool alive = stage > 0;
  // one step's bookkeeping: record it, move on, write the buffer out when
  // full or when the walk ends
  auto advance = [&](int size, int prev) {
    sbuf[n - n0] = (short)state;  // every lane stores the same step
    zbuf[n - n0] = (signed char)size;
    const int stage2 = stage - size;
    const int n2 = n + 1;
    const bool done = prev == S_ && stage2 == 0;
    const bool bad = stage2 < 0 || n2 >= max_steps;
    state = prev;
    stage = stage2;
    n = n2;
    alive = !(done || bad);
    if (n - n0 == kOutSteps || !alive) {  // steps [n0, n) out
      __syncwarp();
      for (int i = n0 + lane; i < n; i += 32) {
        so[i] = sbuf[i - n0];
        zo[i] = zbuf[i - n0];
      }
      __syncwarp();
      n0 = n;
    }
  };
  while (alive) {
    if (state == N_ || state == C_ || state == J_) {
      // a run of N, C or J steps while the chunk holds the walker's row:
      // the same fields and rules as the step below, fewer branches
      const int me = state, other = me == N_ ? S_ : E_;
      const int off = me == N_ ? 0 : me == C_ ? 21 : 26;
      while (stage - 1 >= xc.r0 && stage - 1 < xc.r1) {
        const unsigned v =
            (unsigned)(xbuf[xc.at + stage - 1 - xc.r0] >> off) & 15u;
        advance((int)(v % 5u) + 1, v < 5u ? other : me);
        if (!alive || state != me) break;
      }
      if (!alive) break;
      if (state != me) continue;
    } else if (state >> 14 == CLS_M) {
      // a run of M <- M steps while the tile holds the walker's cell: the
      // column falls by one a step, so only the row waits on the word
      int k = (state & 0x3FFF) - 1;
      while (holds(t, stage - 1, k)) {
        const unsigned f = (unsigned)tiles[t.at + (stage - 1 - t.r0) *
                                           kTileCols + (k - t.c0)] & 31u;
        const unsigned c = f / 5u;  // 0 B, 1 M, 2 I, 3 D
        advance((int)(f - 5u * c) + 1,
                c == 0 ? B_ : c == 1 ? mk(CLS_M, k - 1)
                : c == 2 ? mk(CLS_I, k - 1) : mk(CLS_D, k - 1));
        if (!alive || c != 1) break;
        --k;
      }
      if (!alive) break;
      if (state >> 14 != CLS_M || (state & 0x3FFF) - 1 != k) continue;
    }
    const int cls = (state >> 14) & 3;
    const int idx = (state & 0x3FFF) - 1;
    const int r = stage - 1;
    int size, prev;
    if (cls == 3) {  // a special state reads only its xnode word
      int xv = 0;
      if (r >= 0) {
        if (!holds(xc, r, 0)) {
          land();
          if (holds(xo, r, 0)) {
            swap_spans(xc, xo);
          } else {
            xc = xchunk(r, Lk, vec_xn, xc.at);
            copy_xchunk(xbuf, x, xc, vec_xn);
            land();
          }
          // the chunk below, while the walker reads this one
          xo = xc.r0 > 0 ? xchunk(xc.r0 - 1, Lk, vec_xn, xo.at)
                         : Span{0, 0, 0, 0, xo.at};
          if (xo.r1 > xo.r0) copy_xchunk(xbuf, x, xo, vec_xn);
        }
        xv = xbuf[xc.at + r - xc.r0];
      }
      if (state == N_) {
        size = bits(xv, 0, 4) % 5 + 1;
        prev = bits(xv, 0, 4) / 5 == 0 ? S_ : N_;
      } else if (state == C_) {
        size = bits(xv, 21, 4) % 5 + 1;
        prev = bits(xv, 21, 4) / 5 == 0 ? E_ : C_;
      } else if (state == J_) {
        size = bits(xv, 26, 4) % 5 + 1;
        prev = bits(xv, 26, 4) / 5 == 0 ? E_ : J_;
      } else {
        size = 0;
        if (state == B_) {
          const int v = bits(xv, 4, 2);
          prev = v == 0 ? S_ : v == 1 ? N_ : v == 2 ? E_ : J_;
        } else if (state == E_) {
          const int v = bits(xv, 6, 15);
          prev = v % 2 == 0 ? mk(CLS_M, v / 2) : mk(CLS_D, v / 2);
        } else if (state == T_) {
          prev = bits(xv, 25, 1) == 0 ? E_ : C_;
        } else {
          prev = S_;
        }
      }
    } else {  // a core state reads only its node word
      const int k = min(max(idx, 0), Kp - 1);
      int nv = 0;
      if (r >= 0) {
        if (!holds(t, r, k)) {
          land();
          if (holds(u, r, k)) {
            swap_spans(t, u);
          } else {
            t = ending_at(r, k, kTileRows, kTileCols, Kp, vec_nd, t.at);
            copy_span(tiles, kTileCols, nodes, Kp, t, vec_nd);
            land();
          }
          // the neighbour toward lower rows and columns, overlapping half
          // of this tile each way (never past its last row or column)
          u = ending_at(min(t.r0 + kTileRows / 2, t.r1) - 1,
                        min(t.c0 + kTileCols / 2, t.c1) - 1, kTileRows,
                        kTileCols, Kp, vec_nd, u.at);
          copy_span(tiles, kTileCols, nodes, Kp, u, vec_nd);
        }
        nv = tiles[t.at + (r - t.r0) * kTileCols + (k - t.c0)];
      }
      if (cls == CLS_M) {
        const unsigned f = (unsigned)bits(nv, 0, 5);
        const unsigned c = f / 5u;  // 0 B, 1 M, 2 I, 3 D
        size = (int)(f - 5u * c) + 1;
        prev = c == 0 ? B_ : c == 1 ? mk(CLS_M, idx - 1)
             : c == 2 ? mk(CLS_I, idx - 1) : mk(CLS_D, idx - 1);
      } else if (cls == CLS_I) {
        const unsigned f = (unsigned)bits(nv, 6, 4);
        size = (int)(f % 5u) + 1;
        prev = f < 5u ? mk(CLS_M, idx) : mk(CLS_I, idx);
      } else {  // D
        size = 0;
        prev = bits(nv, 5, 1) == 0 ? mk(CLS_M, idx - 1) : mk(CLS_D, idx - 1);
      }
    }

    advance(size, prev);
  }
  land();  // no copy outlives the CTA
  if (lane == 0) {
    ns[b] = n;
    oks[b] = (state == S_ && stage == 0) ? 1 : 0;
  }
}

}  // namespace

extern "C" int dtt_walk(const void* xn, const void* nd, const void* rows,
                        const void* lens, void* sts, void* szs, void* ns,
                        void* oks, int B, int Lk, int Kp, int max_steps,
                        void* stream) {
  cudaError_t err = cudaFuncSetAttribute(
      walk_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)kWalkSmem);
  if (err != cudaSuccess) return (int)err;
  // 16-byte copies where every row segment starts on 16 bytes
  const bool aligned = ((size_t)xn | (size_t)nd) % 16 == 0;
  const int vec_nd = aligned && Kp % 4 == 0;
  const int vec_xn = aligned && Lk % 4 == 0;
  if (B > 0)
    walk_kernel<<<B, 32, kWalkSmem, (cudaStream_t)stream>>>(
        (const int*)xn, (const int*)nd, (const int*)rows, (const int*)lens,
        (short*)sts, (signed char*)szs, (int*)ns, (unsigned char*)oks, Lk, Kp,
        max_steps, vec_nd, vec_xn);
  return (int)cudaGetLastError();
}
