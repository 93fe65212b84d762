// Pick's tracebacks over a ragged batch of winning hits, one launch a
// pass: for each winner (a query q of n = qend rows against a target t
// of m = tend columns) the (qstart, tstart, m_sum) that
// gappadder_tpu_torch/ops/sw_host.py's `traceback` returns when it walks
// the winner's path back from the cell (qend, tend). The plain twin is
// that module's `alignment_stats_batch`, whose outputs are this
// kernel's contract. It replaces that function's host fill of the whole
// H, E and F matrices (`dp_matrices_batch`) and its walk. There is no
// TPU kernel to port: the JAX package traces on the host as well
// (gappadder_tpu/ops/sw_host.py).
//
// Rules (exact). H, E and F are the int32 values `dp_matrices_batch`
// fills: affine gaps (open `go`, extend `ge`), NEG = -2^28, E and F NEG
// on row and column 0, H 0 there but in `fit` mode's column 0, where H
// and F are -(go + ge (i - 1)); a match only where the two codes are
// equal and the query's is below 4; `local` clamps H at 0. The walk
// prefers the diagonal, then E, then F, and inside a gap extension
// before opening; `local` stops where H is 0, `fit` on row 0.
//
// The forward carry. O_S(i, j), S in {H, E, F}, is the walk's answer
// from cell (i, j) in state S:
//   O_H(i, j) = (i, j, 0)                 local and H = 0
//             = O_H(i-1, j-1) + (0, 0, 1)  H = H(i-1, j-1) + s(i, j)
//             = O_E(i, j)                  H = E
//             = O_F(i, j)                  else (H = F)
//   O_E(i, j) = O_E(i, j-1) if E(i, j) = E(i, j-1) - ge, else O_H(i, j-1)
//   O_F(i, j) = O_F(i-1, j) if F(i, j) = F(i-1, j) - ge, else O_H(i-1, j)
// with O_H = O_E of column 0 (i, 0, 0) in `local` and (0, 0, 0) in `fit`
// (whose walk runs down column 0 to the corner), and O_H = O_F of row 0
// (0, j, 0). Cell (i, j) depends only on cells above it and to its
// left, so the sweep covers rows 1..qend and columns 1..tend of each
// winner alone, and the winner's answer is O_H(qend, tend). A path
// rebuilt any other way could start elsewhere on a tie.
//
// Bound on this card: int32 ALU instruction issue, not bytes. A winner
// reads n + m bytes and writes 12, against about 33 int32 operations for
// each cell in `local` (28 in `fit`): E and F a subtract each for the
// open and the extension, a max, a compare and three selects of the
// origin; the score a compare and a select, the diagonal an add; two
// maxes (and the clamp at 0); H's origin three compares, an add and six
// selects (and the clamp's compare and three selects).
//
// Design: one warp a winner, several winners a block, no shared memory
// and no matrix in device memory. Lane l holds a band of R consecutive
// query rows (rows base + lR + 1 .. base + lR + R), R the least of {1,
// 2, 4, 6, 8, 10, 12, 16} with 32 R >= n (16 past 384 rows), and keeps
// their H, E and the origins O_H and O_E of the column last swept in
// registers. The warp sweeps the columns as an anti-diagonal wavefront:
// at step s lane l computes column j = s - l for all its rows, top to
// bottom, F and its origin flowing down the band, and hands its band's
// last row (H, F, O_H, O_F) to lane l + 1 with __shfl_up_sync; what a
// lane received one step earlier is its first row's diagonal.
//
// Queries longer than 32 x 16 rows are swept in strips of 512 rows, one
// after another (16 rows a lane keep the band's 9 values a row in
// registers). Each strip but the winner's last writes its last row's H,
// F, O_H and O_F, column by column, to the winner's scratch row in
// device memory (lane 31 writes column j right after computing it);
// lane 0 of the next strip reads that row as its upper neighbour. Lane
// 31 writes column j at step j + 31, after lane 0 read it at step j and
// only through values that depend on that read, so one row is read and
// rewritten in place (as csrc/evaluate.cu does).
//
// Winners come ragged: the codes of all winners concatenated, and per
// winner (query offset, n, target offset, m, scratch offset or -1). The
// host hands them over longest first, so the longest sweeps start first.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int WARPS = 4;             // winners per block
constexpr unsigned FULL_MASK = 0xffffffffu;
constexpr int META = 5;              // int32 per winner
constexpr int NEG = -(1 << 28);      // sw_host.NEG
constexpr int NO_CODE = 1 << 10;     // a query code no int8 target code equals
constexpr int STRIP_R = 16;          // rows a lane in a strip of 512 rows
constexpr int EDGE_INTS = 8;         // a strip's last row, a column

struct Args {
  const int* meta;     // [P, META]: q_off, n, t_off, m, s_off
  const int8_t* codes;
  int P, sm, sx, go, ge;
  int* out;            // [3, P]: qstart, tstart, m_sum
  int* scratch;
};

// the walk's answer from a cell: (qstart, tstart, m_sum)
struct Org {
  int q, t, m;
};

__device__ __forceinline__ Org pick(bool c, const Org& a, const Org& b) {
  return {c ? a.q : b.q, c ? a.t : b.t, c ? a.m : b.m};
}

// one row at one column: H, F and their origins
struct Edge {
  int h, f;
  Org oh, of;
};

__device__ __forceinline__ Edge shfl_up(const Edge& e) {
  return {__shfl_up_sync(FULL_MASK, e.h, 1),
          __shfl_up_sync(FULL_MASK, e.f, 1),
          {__shfl_up_sync(FULL_MASK, e.oh.q, 1),
           __shfl_up_sync(FULL_MASK, e.oh.t, 1),
           __shfl_up_sync(FULL_MASK, e.oh.m, 1)},
          {__shfl_up_sync(FULL_MASK, e.of.q, 1),
           __shfl_up_sync(FULL_MASK, e.of.t, 1),
           __shfl_up_sync(FULL_MASK, e.of.m, 1)}};
}

// H and O_H of column 0 at row i
template <bool LOCAL>
__device__ __forceinline__ int h_col0(const Args& a, int i) {
  return LOCAL || i == 0 ? 0 : -(a.go + a.ge * (i - 1));
}

template <bool LOCAL>
__device__ __forceinline__ Org o_col0(int i) {
  return LOCAL ? Org{i, 0, 0} : Org{0, 0, 0};
}

__device__ __forceinline__ void put(const Args& a, int p, const Org& o) {
  a.out[p] = o.q;
  a.out[a.P + p] = o.t;
  a.out[2 * a.P + p] = o.m;
}

// One strip of one winner by one warp: rows base + 1 .. base + 32 R.
// `up_in` holds row base (null: row 0), `up_out` takes the strip's last
// row (null: the winner's last strip, which writes the answer).
template <bool LOCAL, int R>
__device__ __forceinline__ void sweep(const Args& a, int p, int lane, int n,
                                      int m, const int8_t* q, const int8_t* t,
                                      int base, const int* up_in,
                                      int* up_out) {
  const int i0 = base + lane * R + 1;  // first row of this lane's band
  const int sm = a.sm, sx = a.sx, go = a.go, ge = a.ge;
  int qc[R], H[R], E[R];
  Org OH[R], OE[R];
#pragma unroll
  for (int r = 0; r < R; ++r) {
    const int i = i0 + r;
    const int c = i <= n ? static_cast<int>(q[i - 1]) : NO_CODE;
    qc[r] = c < 4 ? c : NO_CODE;
    H[r] = h_col0<LOCAL>(a, i);
    E[r] = NEG;
    OH[r] = o_col0<LOCAL>(i);
    OE[r] = OH[r];
  }
  const int live_lanes = min(32, (n - base + R - 1) / R);
  const int steps = m + live_lanes - 1;
  Edge last{H[R - 1], NEG, OH[R - 1], OH[R - 1]};  // column 0
  // row i0 - 1 at column j - 1; lane 0 starts from row base's column 0
  int dh = h_col0<LOCAL>(a, base);
  Org dorg = o_col0<LOCAL>(base);
  auto code_at = [&](int j) {
    return j >= 1 && j <= m ? static_cast<int>(t[j - 1]) : NO_CODE + 1;
  };
  int tc_next = code_at(1 - lane);
  for (int s = 1; s <= steps; ++s) {
    Edge up = shfl_up(last);
    const int j = s - lane;
    if (lane == 0) {
      if (up_in == nullptr) {
        up = Edge{0, NEG, {0, j, 0}, {0, j, 0}};  // row 0
      } else if (j <= m) {
        const int* u = up_in + static_cast<size_t>(j - 1) * EDGE_INTS;
        up = Edge{u[0], u[1], {u[2], u[3], u[4]}, {u[5], u[6], u[7]}};
      }
    }
    const int tc = tc_next;
    tc_next = code_at(j + 1);
    if (j >= 1 && j <= m) {
      int hu = up.h, fu = up.f, hd = dh;
      Org ohu = up.oh, ofu = up.of, od = dorg;
#pragma unroll
      for (int r = 0; r < R; ++r) {
        const int eo = H[r] - go, ee = E[r] - ge;
        const int e = max(eo, ee);
        const Org oe = pick(ee >= eo, OE[r], OH[r]);
        const int fo = hu - go, fe = fu - ge;
        const int f = max(fo, fe);
        const Org of = pick(fe >= fo, ofu, ohu);
        const int d = hd + (qc[r] == tc ? sm : sx);
        int h = max(d, max(e, f));
        if (LOCAL) h = max(h, 0);
        Org oh = pick(h == e, oe, of);
        oh = pick(h == d, Org{od.q, od.t, od.m + 1}, oh);
        if (LOCAL && h == 0) oh = Org{i0 + r, j, 0};
        hd = H[r];
        od = OH[r];
        H[r] = h;
        E[r] = e;
        OH[r] = oh;
        OE[r] = oe;
        hu = h;
        fu = f;
        ohu = oh;
        ofu = of;
      }
      last = Edge{hu, fu, ohu, ofu};
      if (up_out != nullptr && lane == 31) {
        int* u = up_out + static_cast<size_t>(j - 1) * EDGE_INTS;
        u[0] = hu;
        u[1] = fu;
        u[2] = ohu.q;
        u[3] = ohu.t;
        u[4] = ohu.m;
        u[5] = ofu.q;
        u[6] = ofu.t;
        u[7] = ofu.m;
      }
    }
    dh = up.h;
    dorg = up.oh;
  }
  if (up_out == nullptr) {
    // column m of the band holding row n: the winner's answer
#pragma unroll
    for (int r = 0; r < R; ++r)
      if (i0 + r == n) put(a, p, OH[r]);
  }
}

template <bool LOCAL, int R>
__device__ __forceinline__ void winner_dp(const Args& a, int p, int lane,
                                          int n, int m, const int8_t* q,
                                          const int8_t* t, int* row) {
  for (int base = 0; base < n; base += 32 * R) {
    const int* up_in = base == 0 ? nullptr : row;
    int* up_out = base + 32 * R < n ? row : nullptr;
    sweep<LOCAL, R>(a, p, lane, n, m, q, t, base, up_in, up_out);
    __syncwarp();  // the strip's last row, seen by the next strip
  }
}

template <bool LOCAL>
__global__ void __launch_bounds__(WARPS * 32) traceback_kernel(Args a) {
  const int lane = threadIdx.x & 31;
  const int p = blockIdx.x * WARPS + (threadIdx.x >> 5);
  if (p >= a.P) return;  // the whole warp
  const int* mp = a.meta + static_cast<size_t>(p) * META;
  const int n = mp[1], m = mp[3];
  if (n == 0 || m == 0) {  // the walk starts on row or column 0
    if (lane == 0) put(a, p, n == 0 ? Org{0, m, 0} : o_col0<LOCAL>(n));
    return;
  }
  const int8_t* q = a.codes + mp[0];
  const int8_t* t = a.codes + mp[2];
  int* row = mp[4] >= 0 ? a.scratch + mp[4] : nullptr;
  if (n <= 32) winner_dp<LOCAL, 1>(a, p, lane, n, m, q, t, row);
  else if (n <= 64) winner_dp<LOCAL, 2>(a, p, lane, n, m, q, t, row);
  else if (n <= 128) winner_dp<LOCAL, 4>(a, p, lane, n, m, q, t, row);
  else if (n <= 192) winner_dp<LOCAL, 6>(a, p, lane, n, m, q, t, row);
  else if (n <= 256) winner_dp<LOCAL, 8>(a, p, lane, n, m, q, t, row);
  else if (n <= 320) winner_dp<LOCAL, 10>(a, p, lane, n, m, q, t, row);
  else if (n <= 384) winner_dp<LOCAL, 12>(a, p, lane, n, m, q, t, row);
  else winner_dp<LOCAL, STRIP_R>(a, p, lane, n, m, q, t, row);
}

}  // namespace

// buf: [P, 5] int32 per winner (q_off, n, t_off, m, s_off) followed by
// the int8 codes the offsets index (from buf + 20 P); `local` 1 for
// `local` mode, 0 for `fit`; out int32 [3, P]; scratch int32, 8 m a
// winner with n > 512 at its s_off (may be null where no winner has
// one). All on the card. Returns the launch's CUDA error, or 0.
extern "C" int traceback_launch(const void* buf, int P, int local, int match,
                                int mismatch, int gap_open, int gap_extend,
                                void* out, void* scratch, void* stream) {
  if (P == 0) return 0;
  if (P < 0 || (local != 0 && local != 1))
    return static_cast<int>(cudaErrorInvalidValue);
  const Args a{static_cast<const int*>(buf),
               static_cast<const int8_t*>(buf) + static_cast<size_t>(P) * META
                   * sizeof(int),
               P, match, mismatch, gap_open, gap_extend,
               static_cast<int*>(out), static_cast<int*>(scratch)};
  const unsigned grid = static_cast<unsigned>((P + WARPS - 1) / WARPS);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (local)
    traceback_kernel<true><<<grid, WARPS * 32, 0, s>>>(a);
  else
    traceback_kernel<false><<<grid, WARPS * 32, 0, s>>>(a);
  return static_cast<int>(cudaGetLastError());
}
