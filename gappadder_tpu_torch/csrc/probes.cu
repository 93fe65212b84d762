// The probe kernels that designed the SW kernel, ported to Hopper. They
// replace the five Pallas kernels of scripts/:
//   probe_dynamic_sublane   scripts/tpu_kernel_experiments.py::exp_dynamic_sublane
//   probe_int16_loop        scripts/tpu_kernel_experiments.py::exp_int16_loop
//   probe_int32_argmax      scripts/tpu_kernel_experiments.py::exp_int32_loop_with_argmax
//   probe_swprobe           scripts/swprobe.py::make_kernel / run (levels 0-3)
//   probe_int16_elementwise scripts/mosaic_int16_repro.py (kernel `elementwise`)
//   probe_int16_roll        scripts/mosaic_int16_repro.py (kernel `roll`)
// and compute exactly what those kernels compute (the plain versions are
// in gappadder_tpu_torch/probes/).
//
// Design of the int16 loop and the argmax loop (rows 4 and 5 of PERF.md's
// kernel table): the shift along axis 0 (pltpu.roll(v, 1, 0), row r
// takes row r - 1 and row 0 takes the last row) is the SW recurrence's
// dependency on the row above, so it is mapped as csrc/sw.cu maps its
// rows: one warp a column (the int16 loop: a column pair, two int16
// columns in one int16x2 word), lane l holding the band of rows
// lR .. lR + R - 1 in registers, R the least of {1, 2, 4, 8, 16, 32}
// with 32 R >= S. A step hands each lane's last row to the next lane by
// one __shfl_sync (lane 0 takes the column's last row: the wrap); the
// other rows take their row above from their own registers. The
// recurrence reads the row above's value of the step before, so within
// a step the rows of a band do not depend on each other, and the step's
// chain is one shuffle and three ALU operations. No shared memory, no
// barrier: a block is LOOP_WARPS independent warps and the grid covers
// the columns. The argmax loop's column max and first argmax are two
// warp reductions (redux.sync) a step, off the chain of h and e. The
// TPU kernels carried their state through VMEM scratch across a
// sequential grid; here it stays in registers for the whole loop.
//
// swprobe (row 6) has the same shape: one warp a column, a band of R
// rows a lane holding the five carried arrays A-E in registers, the row
// above's C, D and E by one __shfl_up_sync each (the column's row 0
// takes A or C instead, by a select on lane 0's first row alone). Its
// rolled input tr is data, not state: a warp-private copy of the column
// in shared memory, written once, read at a rotating offset (one LDS a
// row and step, R odd so that the reads hit distinct banks). No
// __syncthreads, no shared state; the column max is one redux.sync.
//
// What bounds them: the loops (rows 4-6) do a few int32 (or int16x2)
// ALU operations per element and step on data that never leaves the SM,
// so at a size that fills the card they are bound by operations (the
// integer pipes' issue), and at the scripts' single-tile shapes (about
// one warp a scheduler) by one warp's issue and the dependent chain of
// a step: rows 4 and 5 wait each step for the shuffle of the row above;
// row 6 issues some 18-19 instructions a row and step at R = 5, its
// next step's tr read ahead, so one warp a scheduler keeps the integer
// pipes about as busy as a full card does. Levels 0 and 1 of row 6 are
// bound at fill by the shared-memory pipe (one 32-lane LDS a clock an
// SM) that their reads of tr take.
//
// The two copies (dynamic_sublane, int16_roll) and int16_elementwise are
// bound by bytes, and at the scripts' shapes by the launch. They share
// one streaming map (`map_range`): dst[i] = op(src[i]) over a contiguous
// range, each thread storing whole 16-byte vectors at 16-byte aligned
// addresses of dst, neighbouring threads on neighbouring vectors, and
// keeping UNROLL loads in flight before it stores; the grid is a few
// blocks an SM and strides over the range. The source may start at any
// element (a row of a table whose width is no multiple of 4, a view 2
// bytes into its storage): the thread then reads the two aligned vectors
// that hold its 16 bytes and shifts them into place with funnel shifts,
// so loads stay 16-byte and coalesced. The elements before dst's first
// aligned vector and after its last are scalar. No shared memory, no
// barrier. The roll of rows (row r takes row r - 1, row 0 the last) is
// two such ranges: out[W:] = x[:(S - 1) W] and out[:W] = x[(S - 1) W:],
// so it takes any number of rows.
//
// int32 additions go through unsigned arithmetic so they wrap as XLA's
// do; the int16x2 SIMD intrinsics wrap per halfword as int16 does.

#include <algorithm>
#include <climits>
#include <cstdint>
#include <type_traits>
#include <cuda_runtime.h>

namespace {

__device__ __forceinline__ int wadd(int a, int b) {
  return static_cast<int>(static_cast<unsigned>(a) + static_cast<unsigned>(b));
}

// ---- the streaming map of the copies ------------------------------------
constexpr int MAP_THREADS = 256;
constexpr int MAP_UNROLL = 4;        // 16-byte loads a thread keeps in flight
constexpr int MAP_BLOCKS_PER_SM = 4;

// the 16 bytes at byte offset m (even, 0..14) of the 32 bytes a:b
__device__ __forceinline__ uint4 shifted(uint4 a, uint4 b, int m) {
  const unsigned s = (m & 3) * 8;
  unsigned w0, w1, w2, w3, w4;
  switch (m >> 2) {
    case 0: w0 = a.x; w1 = a.y; w2 = a.z; w3 = a.w; w4 = b.x; break;
    case 1: w0 = a.y; w1 = a.z; w2 = a.w; w3 = b.x; w4 = b.y; break;
    case 2: w0 = a.z; w1 = a.w; w2 = b.x; w3 = b.y; w4 = b.z; break;
    default: w0 = a.w; w1 = b.x; w2 = b.y; w3 = b.z; w4 = b.w; break;
  }
  uint4 r;
  r.x = __funnelshift_r(w0, w1, s);
  r.y = __funnelshift_r(w1, w2, s);
  r.z = __funnelshift_r(w2, w3, s);
  r.w = __funnelshift_r(w3, w4, s);
  return r;
}

// dst[i] = Op::one(src[i]) for i in [0, n), by every thread of the grid
// (thread `tid` of `nthreads`); Op::vec maps 16 bytes of elements at
// once. The aligned vectors that hold a whole vector's source bytes lie
// inside the source's 16-byte chunks that hold at least one of its bytes,
// so no read leaves the memory the source's pages map.
template <typename T, class Op>
__device__ __forceinline__ void map_range(const T* __restrict__ src,
                                          T* __restrict__ dst, long long n,
                                          long long tid, long long nthreads) {
  constexpr int V = 16 / sizeof(T);
  const long long to_aligned =
      ((16 - (reinterpret_cast<uintptr_t>(dst) & 15)) & 15) / sizeof(T);
  const long long head = to_aligned < n ? to_aligned : n;
  const long long nvec = (n - head) / V;
  const long long body_end = head + nvec * V;
  const long long scalars = head + (n - body_end);
  for (long long i = tid; i < scalars; i += nthreads) {
    const long long e = i < head ? i : body_end + (i - head);
    dst[e] = Op::one(src[e]);
  }
  if (nvec == 0) return;
  uint4* dv = reinterpret_cast<uint4*>(dst + head);
  const uintptr_t sb = reinterpret_cast<uintptr_t>(src + head);
  const int m = static_cast<int>(sb & 15);
  const uint4* sv = reinterpret_cast<const uint4*>(sb - m);
  for (long long base = tid; base < nvec; base += MAP_UNROLL * nthreads) {
    uint4 v[MAP_UNROLL];
#pragma unroll
    for (int k = 0; k < MAP_UNROLL; ++k) {
      const long long u = base + k * nthreads;
      if (u < nvec) v[k] = m ? shifted(sv[u], sv[u + 1], m) : sv[u];
    }
#pragma unroll
    for (int k = 0; k < MAP_UNROLL; ++k) {
      const long long u = base + k * nthreads;
      if (u < nvec) dv[u] = Op::vec(v[k]);
    }
  }
}

struct Copy {
  template <typename T>
  static __device__ __forceinline__ T one(T v) { return v; }
  static __device__ __forceinline__ uint4 vec(uint4 v) { return v; }
};

// int16 max(x + 3, x - 2), wrapping as int16 does
struct AddSubMax {
  static __device__ __forceinline__ int16_t one(int16_t v) {
    const int16_t a = static_cast<int16_t>(v + 3);
    const int16_t b = static_cast<int16_t>(v - 2);
    return a > b ? a : b;
  }
  static __device__ __forceinline__ unsigned word(unsigned w) {
    return __vmaxs2(__vadd2(w, 0x00030003u), __vsub2(w, 0x00020002u));
  }
  static __device__ __forceinline__ uint4 vec(uint4 v) {
    return make_uint4(word(v.x), word(v.y), word(v.z), word(v.w));
  }
};

__device__ __forceinline__ long long grid_tid() {
  return static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
}

__device__ __forceinline__ long long grid_threads() {
  return static_cast<long long>(gridDim.x) * blockDim.x;
}

// ---- exp_dynamic_sublane: out[0, :] = t[j, :] with j read on the device.
// The index is normalised as the JAX kernel's ref slice does it in
// interpret mode: a negative j counts from the end, then the start is
// clamped into the array as XLA clamps a dynamic slice.
__global__ void dynamic_sublane_kernel(const int* __restrict__ idx,
                                       const int* __restrict__ t, int R,
                                       int W, int* __restrict__ out) {
  int j = idx[0];
  if (j < 0) j += R;
  j = min(max(j, 0), R - 1);
  map_range<int, Copy>(t + static_cast<long long>(j) * W, out, W,
                       grid_tid(), grid_threads());
}

// ---- exp_int16_loop: `steps` steps of
//   e = max(h - 1, e - 1); h = max(roll(h, 1, 0) + 1, e); h = max(h, -16384)
// from h = e = int16(x), out = int32(h). LANES = 2 packs two int16
// columns (a warp's column pair; the last pair of an odd width has a
// dead high half) into one 32-bit register and runs the int16x2 SIMD
// intrinsics (per-halfword, wrapping: int16's own arithmetic): that is
// the port of exp_int16_loop. Three yardsticks for the SW redesign share
// the source and are timed beside it, equal to it only where nothing
// wraps: LANES = 1 runs the recurrence on one int32 column a warp, and
// DPX writes each max(a + b, c) as one DPX intrinsic (__viaddmax_s16x2 /
// __viaddmax_s32). CUDA 12.8's header lowers the 16-bit one on sm_90 to
// add.s16x2 + max.s16x2, which wrap; the port keeps the plain intrinsics,
// whose per-halfword wrap is documented.
template <int LANES>
struct Lane;

template <>
struct Lane<2> {
  // the word of columns p[0] and, if `pair`, p[1] (else the high half
  // is dead: neither read nor written)
  static __device__ __forceinline__ unsigned load(const int* p, bool pair) {
    return (static_cast<unsigned>(p[0]) & 0xffffu) |
           (pair ? static_cast<unsigned>(p[1]) << 16 : 0u);
  }
  static __device__ __forceinline__ void store(int* p, unsigned v,
                                               bool pair) {
    p[0] = static_cast<int16_t>(v & 0xffffu);
    if (pair) p[1] = static_cast<int16_t>(v >> 16);
  }
  static __device__ __forceinline__ unsigned add(unsigned a, int b) {
    return __vadd2(a, (static_cast<unsigned>(b) & 0xffffu) * 0x10001u);
  }
  static __device__ __forceinline__ unsigned max(unsigned a, unsigned b) {
    return __vmaxs2(a, b);
  }
  static __device__ __forceinline__ unsigned splat(int v) {
    return (static_cast<unsigned>(v) & 0xffffu) * 0x10001u;
  }
  static __device__ __forceinline__ unsigned dpx_addmax(unsigned a, int b,
                                                        unsigned c) {
    return __viaddmax_s16x2(a, splat(b), c);
  }
};

template <>
struct Lane<1> {
  static __device__ __forceinline__ unsigned load(const int* p, bool) {
    return static_cast<unsigned>(p[0]);
  }
  static __device__ __forceinline__ void store(int* p, unsigned v, bool) {
    p[0] = static_cast<int>(v);
  }
  static __device__ __forceinline__ unsigned add(unsigned a, int b) {
    return a + static_cast<unsigned>(b);
  }
  static __device__ __forceinline__ unsigned max(unsigned a, unsigned b) {
    return static_cast<unsigned>(::max(static_cast<int>(a),
                                       static_cast<int>(b)));
  }
  static __device__ __forceinline__ unsigned splat(int v) {
    return static_cast<unsigned>(v);
  }
  static __device__ __forceinline__ unsigned dpx_addmax(unsigned a, int b,
                                                        unsigned c) {
    return static_cast<unsigned>(__viaddmax_s32(static_cast<int>(a), b,
                                                static_cast<int>(c)));
  }
};

// max(a + b, c): two instructions, or one DPX instruction (sm_90)
template <int LANES, bool DPX>
__device__ __forceinline__ unsigned addmax(unsigned a, int b, unsigned c) {
  using L = Lane<LANES>;
  if constexpr (DPX) return L::dpx_addmax(a, b, c);
  else return L::max(L::add(a, b), c);
}

constexpr unsigned FULL_MASK = 0xffffffffu;
// columns (pairs) a block, one a warp. The loops' launch bounds ask for
// one block an SM at least: without that minimum ptxas capped the
// 32-row bands at 96 registers and spilled to local memory in the loop.
constexpr int LOOP_WARPS = 4;

// A warp's column of S rows in bands of R a lane. FULL (S = 32 R): every
// row is live and lane 0 takes its row above from lane 31's last row.
// Otherwise the rows from S on are dead (the lanes past `last`, and lane
// `last`'s registers past `give`): they run the step on garbage, are
// never stored and feed no live row, because lane `last` hands on the
// column's last row, row S - 1 (its register `give`), and lane 0 takes
// that. No register is indexed at run time: the row handed on is an
// unrolled select chain over the band, and only where S != 32 R.
template <int R, bool FULL>
struct Band {
  int lane;   // this lane
  int src;    // the lane whose handed-on row is this lane's first row's above
  int give;   // this lane's register it hands on
  int live;   // this lane's rows below S
  __device__ __forceinline__ explicit Band(int S) {
    lane = threadIdx.x & 31;
    const int last = FULL ? 31 : (S - 1) / R;
    src = lane == 0 ? last : lane - 1;
    give = FULL || lane != last ? R - 1 : (S - 1) % R;
    live = FULL ? R : ::min(::max(S - lane * R, 0), R);
  }
  template <typename T>
  __device__ __forceinline__ T handed(const T (&h)[R]) const {
    T v = h[R - 1];
    if (!FULL) {
#pragma unroll
      for (int k = 0; k < R - 1; ++k) v = give == k ? h[k] : v;
    }
    return v;
  }
};

template <int LANES, bool DPX, int R, bool FULL>
__global__ void __launch_bounds__(32 * LOOP_WARPS, 1)
loop_kernel(const int* __restrict__ x, int S, int W, int steps,
            int* __restrict__ out) {
  using L = Lane<LANES>;
  const int col = (blockIdx.x * LOOP_WARPS + threadIdx.x / 32) * LANES;
  if (col >= W) return;                              // the whole warp
  const bool pair = LANES == 2 && col + 1 < W;
  const Band<R, FULL> band(S);
  const size_t at = static_cast<size_t>(band.lane) * R * W + col;
  const unsigned floor_ = L::splat(-16384);
  unsigned h[R], e[R];
#pragma unroll
  for (int k = 0; k < R; ++k) {
    h[k] = k < band.live ? L::load(x + at + static_cast<size_t>(k) * W, pair)
                         : 0u;
    e[k] = h[k];
  }
  for (int s = 0; s < steps; ++s) {
    const unsigned up = __shfl_sync(FULL_MASK, band.handed(h), band.src);
#pragma unroll
    for (int k = 0; k < R; ++k)
      e[k] = addmax<LANES, DPX>(h[k], -1, L::add(e[k], -1));
#pragma unroll
    for (int k = R - 1; k > 0; --k)
      h[k] = L::max(addmax<LANES, DPX>(h[k - 1], 1, e[k]), floor_);
    h[0] = L::max(addmax<LANES, DPX>(up, 1, e[0]), floor_);
  }
#pragma unroll
  for (int k = 0; k < R; ++k)
    if (k < band.live) L::store(out + at + static_cast<size_t>(k) * W, h[k], pair);
}

// ---- exp_int32_loop_with_argmax: `steps` steps of
//   e = max(h - 1, e - 1); h = max(roll(h, 1, 0) + 1, e)
//   m = max over rows of h; am = first row of the max of float32(h)
//   bs = max(bs, m)
// from h = e = x, bs = 0; out = h + bs, amax = the last step's am. The
// JAX kernel drops am (it adds am * 0); returning the last one keeps the
// per-step cross-row argmax, the point of the probe, from being removed.
// A lane folds its rows to an int max, one redux.sync gives the
// column's max m. float32 rounding is monotone, so the max of
// float32(h) is float32(m) and the first argmax is the least row whose
// float32 equals it: each lane finds its first such row (S if none) and
// a second redux.sync takes the least. Neither reduction feeds the next
// step's h or e.
template <int R, bool FULL>
__global__ void __launch_bounds__(32 * LOOP_WARPS, 1)
int32_argmax_kernel(const int* __restrict__ x, int S, int W, int steps,
                    int* __restrict__ out, int* __restrict__ amax) {
  const int col = blockIdx.x * LOOP_WARPS + threadIdx.x / 32;
  if (col >= W) return;                              // the whole warp
  const Band<R, FULL> band(S);
  const int r0 = band.lane * R;
  const size_t at = static_cast<size_t>(r0) * W + col;
  int h[R], e[R];
#pragma unroll
  for (int k = 0; k < R; ++k) {
    h[k] = k < band.live ? x[at + static_cast<size_t>(k) * W] : 0;
    e[k] = h[k];
  }
  int bs = 0, am = 0;
  // One step a trip keeps every step's argmax: am leaves the loop, and
  // no trip knows it is the last. In a trip of two ptxas drops the first
  // step's, which the second overwrites, even behind an empty asm (it
  // reaches no instruction).
#pragma unroll 1
  for (int s = 0; s < steps; ++s) {
    const int up = __shfl_sync(FULL_MASK, band.handed(h), band.src);
#pragma unroll
    for (int k = 0; k < R; ++k) e[k] = max(wadd(h[k], -1), wadd(e[k], -1));
#pragma unroll
    for (int k = R - 1; k > 0; --k) h[k] = max(wadd(h[k - 1], 1), e[k]);
    h[0] = max(wadd(up, 1), e[0]);
    int lane_max = INT_MIN;
#pragma unroll
    for (int k = 0; k < R; ++k)
      if (k < band.live) lane_max = max(lane_max, h[k]);
    const int m = __reduce_max_sync(FULL_MASK, lane_max);
    const float fm = __int2float_rn(m);
    unsigned first = S;
#pragma unroll
    for (int k = R - 1; k >= 0; --k)
      if (k < band.live && __int2float_rn(h[k]) == fm) first = r0 + k;
    am = static_cast<int>(__reduce_min_sync(FULL_MASK, first));
    bs = max(bs, m);
  }
#pragma unroll
  for (int k = 0; k < R; ++k)
    if (k < band.live) out[at + static_cast<size_t>(k) * W] = wadd(h[k], bs);
  if (band.lane == 0) amax[col] = am;
}

// ---- swprobe: the SW-shaped ladder. Per column, `nstep` steps in
// `nstep / chunk` grid steps of `chunk` (the JAX kernel's fori_loop,
// whose index s restarts at 0 in every grid step). The rolled buffer
// rb = concat(x, x) of the JAX kernel is rolled once a step from the
// first step on, so at step g its rows S..2S-1 are tr[r] = x[(r - g - 1)
// mod S]. LEVEL 0 is the loop alone (that read, kept live); 1 adds A's
// update; 2 adds B and C and the exchange of C; 3 is the full SW-like
// step (D and E exchanged as well). A level's state that it does not
// update stays at its initial x + k.
//
// One warp a column, lane l holding rows r0 = lR .. lR + R - 1 of A-E in
// registers (`with_odd_band`). C and D take their row above's value of
// the step before, and E the row above's E1 (this step's E before the
// roll), so within a step the rows of a band do not depend on each
// other: rows 1..R-1 take theirs from the lane's own registers
// (descending k, in place), row 0 from the lane before by one
// __shfl_up_sync each, and the column's row 0 (lane 0, k = 0) takes A
// (C for E) instead: three shuffles a step at level 3, one at level 2.
// No wrap: the row above row 0 is never read, so dead rows (from S on)
// feed only dead rows, and the column max skips them.
//
// tr is data, not state: each warp keeps its column of x in shared
// memory twice over, xs[i] = x[i mod S] for i < S + 32 R, written once
// before the loop. At step g row r reads xs[b + r] with b = (-g - 1)
// mod S, so lane l's R reads are xs[b + lR + k], one LDS each at an
// immediate offset from one address a step. R odd (1, or 2^p + 1) puts
// the 32 lanes of one k on 32 distinct banks (stride R, coprime with 32)
// with no swizzle arithmetic, where an even R would conflict R ways.
template <int LEVEL, int R>
__global__ void __launch_bounds__(32 * LOOP_WARPS, 1)
swprobe_kernel(const int* __restrict__ x, int S, int W, int nstep,
               int chunk, int* __restrict__ out) {
  extern __shared__ int sh_sw[];
  const int warp = threadIdx.x / 32;
  const int col = blockIdx.x * LOOP_WARPS + warp;
  if (col >= W) return;                              // the whole warp
  const int lane = threadIdx.x & 31;
  const int span = S + 32 * R;
  int* xs = sh_sw + warp * span;
  for (int i = lane; i < span; i += 32)
    xs[i] = x[static_cast<size_t>(i % S) * W + col];
  __syncwarp();
  const int r0 = lane * R;
  const int* xl = xs + r0;
  const bool first = lane == 0;                      // holds the column's row 0
  int A[R], B[R], C[R], D[R], E[R];
#pragma unroll
  for (int k = 0; k < R; ++k) {
    A[k] = xl[k];
    B[k] = wadd(A[k], 1);
    C[k] = wadd(A[k], 2);
    D[k] = wadd(A[k], 3);
    E[k] = wadd(A[k], 4);
  }
  // tr of step g + 1 is read during step g, so no step waits for its
  // LDS; unrolled by two at levels 2-3 (by four at levels 0-1, where the
  // chain is short) the copy from trn to tr is a renaming, not moves
  int b = S - 1;                                      // (-g - 1) mod S
  int s = 0;                                          // the fori_loop index
  int trn[R];
#pragma unroll
  for (int k = 0; k < R; ++k) trn[k] = xl[b + k];
#pragma unroll(LEVEL >= 2 ? 2 : 4)
  for (int g = 0; g < nstep; ++g) {
    const int* t = xl + b;
    int tr[R];
#pragma unroll
    for (int k = 0; k < R; ++k) tr[k] = trn[k];
    b = b == 0 ? S - 1 : b - 1;
#pragma unroll
    for (int k = 0; k < R; ++k) trn[k] = xl[b + k];
    if (LEVEL == 0) {
      // volatile loads: ptxas drops a load whose value only an empty asm
      // reads, and with it the whole loop
#pragma unroll
      for (int k = 0; k < R; ++k)
        asm volatile("" ::"r"(static_cast<const volatile int*>(t)[k]));
    }
    if (LEVEL >= 1) {
#pragma unroll
      for (int k = 0; k < R; ++k) A[k] = max(wadd(A[k], -1), tr[k]);
      if (first) A[0] = tr[0];
    }
    if (LEVEL >= 2) {
      const int upC = __shfl_up_sync(FULL_MASK, C[R - 1], 1);
#pragma unroll
      for (int k = 0; k < R; ++k) B[k] = max(wadd(B[k], -2), wadd(A[k], -7));
#pragma unroll
      for (int k = R - 1; k > 0; --k) C[k] = max(C[k - 1], B[k]);
      C[0] = max(first ? A[0] : upC, B[0]);
#pragma unroll
      for (int k = 0; k < R; ++k) A[k] = max(A[k], C[k]);
    }
    if (LEVEL >= 3) {
      const int upD = __shfl_up_sync(FULL_MASK, D[R - 1], 1);
#pragma unroll
      for (int k = R - 1; k > 0; --k) D[k] = max(D[k - 1], wadd(C[k], -1));
      D[0] = max(first ? A[0] : upD, wadd(C[0], -1));
      // row r0 + k keeps B iff 1 <= r0 + k <= s
      const int u = s - r0;
      const int e1_last = max(D[R - 1], E[R - 1]);
#pragma unroll
      for (int k = R - 1; k >= 0; --k) {
        const int e1 = k == R - 1 ? e1_last : max(D[k], E[k]);
        A[k] = max(wadd(A[k], tr[k] == A[k] ? 1 : -4), D[k]);
        B[k] = k <= u && (k > 0 || !first) ? B[k] : e1;
        C[k] = max(C[k], 0);
        if (k < R - 1) E[k + 1] = e1;
      }
      const int upE = __shfl_up_sync(FULL_MASK, e1_last, 1);
      E[0] = first ? C[0] : upE;
      s = s + 1 == chunk ? 0 : s + 1;
    }
  }
  const int live = ::min(::max(S - r0, 0), R);
  int m = INT_MIN;
#pragma unroll
  for (int k = 0; k < R; ++k)
    if (k < live)
      m = max(m, wadd(wadd(wadd(A[k], B[k]), wadd(C[k], D[k])), E[k]));
  m = __reduce_max_sync(FULL_MASK, m);
  if (first) out[col] = m;
}

// ---- mosaic_int16_repro: int16 max(x + 3, x - 2), 8 lanes a thread.
__global__ void int16_elementwise_kernel(const int16_t* __restrict__ x,
                                         long long n,
                                         int16_t* __restrict__ out) {
  map_range<int16_t, AddSubMax>(x, out, n, grid_tid(), grid_threads());
}

// ---- mosaic_int16_repro: int16 roll(x, 1, axis 0) of x [S, W]: row r
// takes row r - 1 and row 0 the last, as two contiguous ranges.
__global__ void int16_roll_kernel(const int16_t* __restrict__ x, int S, int W,
                                  int16_t* __restrict__ out) {
  const long long tid = grid_tid(), nt = grid_threads();
  const long long rest = static_cast<long long>(S - 1) * W;
  map_range<int16_t, Copy>(x, out + W, rest, tid, nt);
  map_range<int16_t, Copy>(x + rest, out, W, tid, nt);
}

// makes `device` current for a launch and gives the caller's back after
struct OnDevice {
  int prev = -1;
  explicit OnDevice(int device) {
    int cur = device;
    cudaGetDevice(&cur);
    if (cur != device) {
      prev = cur;
      cudaSetDevice(device);
    }
  }
  ~OnDevice() {
    if (prev >= 0) cudaSetDevice(prev);
  }
};

// blocks of MAP_THREADS for a map over `bytes` bytes on `device`: enough
// for each thread's first MAP_UNROLL vectors, at most MAP_BLOCKS_PER_SM an
// SM. The SM count is queried once a device (kept for the first 64) and
// the query's error returned.
cudaError_t map_blocks(long long bytes, int device, int* blocks) {
  static int known[64];
  const bool keep = device >= 0 && device < 64;
  int sms = keep ? known[device] : 0;
  if (sms == 0) {
    const cudaError_t err =
        cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
    if (err != cudaSuccess) return err;
    if (keep) known[device] = sms;
  }
  const long long per_block = 16LL * MAP_THREADS * MAP_UNROLL;
  const long long need = (bytes + per_block - 1) / per_block;
  const long long cap = static_cast<long long>(MAP_BLOCKS_PER_SM) * sms;
  *blocks = static_cast<int>(std::max(1LL, std::min(need, cap)));
  return cudaSuccess;
}

int grid_for(int groups, int cols) { return (groups + cols - 1) / cols; }

// f(std::integral_constant<int, R>()) for the band of S rows a lane: the
// least R of {1, 2, 4, 8, 16, 32} with 32 R >= S (1 <= S <= 1024)
template <class F>
void with_band(int S, F f) {
  if (S <= 32) f(std::integral_constant<int, 1>());
  else if (S <= 64) f(std::integral_constant<int, 2>());
  else if (S <= 128) f(std::integral_constant<int, 4>());
  else if (S <= 256) f(std::integral_constant<int, 8>());
  else if (S <= 512) f(std::integral_constant<int, 16>());
  else f(std::integral_constant<int, 32>());
}

// f(std::integral_constant<int, R>()) for swprobe's band of S rows a
// lane: the least R of {1, 3, 5, 9, 17, 33} with 32 R >= S
// (1 <= S <= 1024); odd, so a step's reads of x hit distinct banks
template <class F>
void with_odd_band(int S, F f) {
  if (S <= 32) f(std::integral_constant<int, 1>());
  else if (S <= 96) f(std::integral_constant<int, 3>());
  else if (S <= 160) f(std::integral_constant<int, 5>());
  else if (S <= 288) f(std::integral_constant<int, 9>());
  else if (S <= 544) f(std::integral_constant<int, 17>());
  else f(std::integral_constant<int, 33>());
}

template <int LEVEL, int R>
void launch_swprobe(int blocks, cudaStream_t st, const int* x, int S, int W,
                    int nstep, int chunk, int* out) {
  const size_t smem = sizeof(int) * LOOP_WARPS * (S + 32 * R);
  swprobe_kernel<LEVEL, R><<<blocks, 32 * LOOP_WARPS, smem, st>>>(
      x, S, W, nstep, chunk, out);
}

template <int LANES, bool DPX, int R>
void launch_loop(int blocks, cudaStream_t st, const int* x, int S, int W,
                 int steps, int* out) {
  if (S == 32 * R)
    loop_kernel<LANES, DPX, R, true><<<blocks, 32 * LOOP_WARPS, 0, st>>>(x, S, W, steps, out);
  else
    loop_kernel<LANES, DPX, R, false><<<blocks, 32 * LOOP_WARPS, 0, st>>>(x, S, W, steps, out);
}

int loop(const void* x, int S, int W, int steps, int lanes, int dpx,
         void* out, int device, void* stream) {
  if (S <= 0 || W <= 0) return 0;
  if (S > 32 * 32) return static_cast<int>(cudaErrorInvalidValue);
  OnDevice on(device);
  const int blocks = grid_for(grid_for(W, lanes), LOOP_WARPS);
  auto st = static_cast<cudaStream_t>(stream);
  auto xi = static_cast<const int*>(x);
  auto o = static_cast<int*>(out);
  with_band(S, [&](auto band) {
    constexpr int R = decltype(band)::value;
    if (lanes == 2 && !dpx) launch_loop<2, false, R>(blocks, st, xi, S, W, steps, o);
    else if (lanes == 2) launch_loop<2, true, R>(blocks, st, xi, S, W, steps, o);
    else if (!dpx) launch_loop<1, false, R>(blocks, st, xi, S, W, steps, o);
    else launch_loop<1, true, R>(blocks, st, xi, S, W, steps, o);
  });
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// Every entry takes the index of the device that holds its tensors and
// launches there on `stream`, which must belong to it; it returns the
// launch's cudaError.
int probe_dynamic_sublane(const void* idx, const void* t, int R, int W,
                          void* out, int device, void* stream) {
  if (R <= 0 || W <= 0) return 0;
  OnDevice on(device);
  int blocks = 0;
  if (cudaError_t err = map_blocks(4LL * W, device, &blocks))
    return static_cast<int>(err);
  auto st = static_cast<cudaStream_t>(stream);
  dynamic_sublane_kernel<<<blocks, MAP_THREADS, 0, st>>>(
      static_cast<const int*>(idx), static_cast<const int*>(t), R, W,
      static_cast<int*>(out));
  return static_cast<int>(cudaGetLastError());
}

int probe_int16_loop(const void* x, int S, int W, int steps, void* out,
                     int device, void* stream) {
  return loop(x, S, W, steps, 2, 0, out, device, stream);
}

// the yardsticks of the int16 loop: int32 lanes (lanes = 1), DPX forms
int probe_loop_yardstick(const void* x, int S, int W, int steps, int lanes,
                         int dpx, void* out, int device, void* stream) {
  return loop(x, S, W, steps, lanes, dpx, out, device, stream);
}

int probe_int32_argmax(const void* x, int S, int W, int steps, void* out,
                       void* amax, int device, void* stream) {
  if (S <= 0 || W <= 0) return 0;
  if (S > 32 * 32 || steps < 1) return static_cast<int>(cudaErrorInvalidValue);
  OnDevice on(device);
  const int blocks = grid_for(W, LOOP_WARPS);
  auto st = static_cast<cudaStream_t>(stream);
  auto xi = static_cast<const int*>(x);
  auto o = static_cast<int*>(out);
  auto a = static_cast<int*>(amax);
  with_band(S, [&](auto band) {
    constexpr int R = decltype(band)::value;
    if (S == 32 * R)
      int32_argmax_kernel<R, true><<<blocks, 32 * LOOP_WARPS, 0, st>>>(xi, S, W, steps, o, a);
    else
      int32_argmax_kernel<R, false><<<blocks, 32 * LOOP_WARPS, 0, st>>>(xi, S, W, steps, o, a);
  });
  return static_cast<int>(cudaGetLastError());
}

int probe_swprobe(const void* x, int S, int W, int nstep, int chunk,
                  int level, void* out, int device, void* stream) {
  if (S <= 0 || W <= 0) return 0;
  if (S > 32 * 32 || level < 0 || level > 3 || (nstep > 0 && chunk < 1))
    return static_cast<int>(cudaErrorInvalidValue);
  OnDevice on(device);
  const int blocks = grid_for(W, LOOP_WARPS);
  auto st = static_cast<cudaStream_t>(stream);
  auto xi = static_cast<const int*>(x);
  auto o = static_cast<int*>(out);
  with_odd_band(S, [&](auto band) {
    constexpr int R = decltype(band)::value;
    switch (level) {
      case 0: launch_swprobe<0, R>(blocks, st, xi, S, W, nstep, chunk, o); break;
      case 1: launch_swprobe<1, R>(blocks, st, xi, S, W, nstep, chunk, o); break;
      case 2: launch_swprobe<2, R>(blocks, st, xi, S, W, nstep, chunk, o); break;
      default: launch_swprobe<3, R>(blocks, st, xi, S, W, nstep, chunk, o); break;
    }
  });
  return static_cast<int>(cudaGetLastError());
}

int probe_int16_elementwise(const void* x, long long n, void* out,
                            int device, void* stream) {
  if (n <= 0) return 0;
  OnDevice on(device);
  int blocks = 0;
  if (cudaError_t err = map_blocks(2 * n, device, &blocks))
    return static_cast<int>(err);
  auto st = static_cast<cudaStream_t>(stream);
  int16_elementwise_kernel<<<blocks, MAP_THREADS, 0, st>>>(
      static_cast<const int16_t*>(x), n, static_cast<int16_t*>(out));
  return static_cast<int>(cudaGetLastError());
}

int probe_int16_roll(const void* x, int S, int W, void* out, int device,
                     void* stream) {
  if (S <= 0 || W <= 0) return 0;
  OnDevice on(device);
  int blocks = 0;
  if (cudaError_t err = map_blocks(2LL * S * W, device, &blocks))
    return static_cast<int>(err);
  auto st = static_cast<cudaStream_t>(stream);
  int16_roll_kernel<<<blocks, MAP_THREADS, 0, st>>>(
      static_cast<const int16_t*>(x), S, W, static_cast<int16_t*>(out));
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
