// The ContigsMerger Evaluate overlap DP over a ragged batch of contig
// pairs, one launch a batch: for each pair (query s1 of n rows, target
// s2 of m columns) the six numbers (best, pos_row, pos_col, nclip,
// ends_i0, ends_j0) that gappadder_tpu_torch/ops/evaluate_dp.py's
// eval_batch_kernel computes. It replaces that module's loop of torch
// operators over the query's rows (no Pallas kernel: the JAX package's
// Evaluate, gappadder_tpu/ops/evaluate_dp.py, is an XLA lax.scan, whose
// counterpart this is).
//
// Rules (exact, as the module's docstring states them): free start on
// both sequences (H row 0 and column 0 are 0), linear indels `ind`, raw
// equality of codes (N matches N). Endpoint flags: bit 0 = the
// traceback from a cell stops on row 0, bit 1 = on column 0; E(0,0) = 3,
// E(0,j) = 1, E(i,0) = 2, carried with H through the pointer preference
// (left if left > max(diag, up), else up if up > diag, else diagonal).
// End scan: c = 0..max_clip, column m - c before row n - c, a column's
// candidates rows 0..n and a row's columns 0..m, the first maximum of a
// line (lowest index) and strict improvement only.
//
// Bound on this card: int32 ALU instruction issue, not bytes. A pair
// reads n + m bytes and writes 24, against about 12 int32 operations
// for each live cell: the score a compare and a select, three adds
// (diagonal, up, left), two maxes, one and to clear the preference
// bits, and the row candidates' compare and two selects.
//
// One cell is one int32, X = 16 H + 4 p + E: H the score, E the 2-bit
// endpoint flags, p the move's preference (diagonal 2, up 1, left 0),
// which is 0 in a stored cell. The three moves are the stored
// neighbours plus 16 s + 8, 16 ind + 4 and 16 ind, so one max of three
// picks the highest H and, among equal H, the preferred move, and
// carries that move's flags with it; `& ~12` clears p again.
//
// The end scan is one reduction. Its winner is the candidate of the
// highest H, then of the lowest scan index (2c for column m - c,
// 2c + 1 for row n - c), then of the lowest index in its line. Every
// line holds a cell of H 0 (row 0 or column 0), and column m's row 0,
// (0, scan 0, row 0, flags 1), is the least of them in that order: each
// lane starts from it, and a cell is a candidate only with H > 0.
//
// Design: one warp a pair, several pairs a block, no shared memory and
// no matrix in device memory. Lane l holds a band of R consecutive
// query rows (rows base + lR + 1 .. base + lR + R), R the least of
// {2, 4, 6, 8, 12, 16, 24, 32} with 32 R >= n (32 past 1024 rows), and
// keeps their X in registers. The warp sweeps the columns as an
// anti-diagonal wavefront: at step s lane l computes column j = s - l
// for all its rows, top to bottom, and hands its band's last row to
// lane l + 1 with one __shfl_up_sync a step; the value a lane received
// one step earlier is its first row's diagonal. A row's candidates are
// kept by the lane that holds it (its first strict maximum in column
// order, and the column); a candidate column's by each lane over its
// band (first strict maximum down the rows), folded into the lane's
// running winner. At the end the warp folds its lanes' winners.
//
// Queries longer than 32 x 32 rows are swept in strips of 1024 rows,
// one after another. Each strip but the pair's last writes its last
// row's X, column by column, to the pair's scratch row in device memory
// (lane 31 writes column j right after computing it); lane 0 of the
// next strip reads that row as its upper neighbour. Lane 31 writes
// column j at step j + 31, after lane 0 read it at step j and only
// through values that depend on that read, so one row is read and
// rewritten in place (as csrc/sw.cu does).
//
// Pairs come ragged: the codes of all pairs concatenated, and per pair
// (query offset, n, target offset, m, scratch offset or -1). The host
// hands the pairs over longest first, so the longest sweeps start
// first.

#include <climits>
#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int WARPS = 4;  // pairs per block
constexpr unsigned FULL_MASK = 0xffffffffu;
constexpr int NO_CODE = 1 << 10;  // a query code no int8 target code equals
constexpr int META = 5;           // int32 per pair

struct Args {
  const int* meta;     // [P, META]: q_off, n, t_off, m, s_off
  const int8_t* codes;
  int P, max_clip, sm, sx, iu, il;  // 16 match + 8, 16 mismatch + 8,
                                    // 16 ind + 4, 16 ind
  int* out;            // [P, 6]
  int* scratch;
};

// the running winner of the end scan, in its order
struct Best {
  int h, scan, at, flags;
  __device__ __forceinline__ void consider(int h2, int s2, int a2, int f2) {
    if (h2 > h || (h2 == h && (s2 < scan || (s2 == scan && a2 < at)))) {
      h = h2;
      scan = s2;
      at = a2;
      flags = f2;
    }
  }
};

// One strip of one pair by one warp: rows base + 1 .. base + 32 R.
// `up_in` holds row base's X (null: row 0), `up_out` takes the strip's
// last row (null: the pair's last strip).
template <int R>
__device__ __forceinline__ void sweep(const Args& a, int lane, int n, int m,
                                      const int8_t* q, const int8_t* t,
                                      int base, const int* up_in, int* up_out,
                                      Best& best) {
  const int i0 = base + lane * R + 1;  // first row of this lane's band
  const int row_lo = max(1, n - a.max_clip);  // first candidate row
  const int col_lo = max(1, m - a.max_clip);  // first candidate column
  const int sm = a.sm, sx = a.sx, iu = a.iu, il = a.il;
  int X[R], qc[R], rb[R], rj[R];
#pragma unroll
  for (int r = 0; r < R; ++r) {
    const int i = i0 + r;
    qc[r] = i <= n ? static_cast<int>(q[i - 1]) : NO_CODE;
    X[r] = 2;  // X(i, 0): H 0, flags 2
    // a candidate row records cells of H > 0 (X > 15); others none
    rb[r] = i >= row_lo && i <= n ? 15 : INT_MAX;
    rj[r] = 0;
  }
  const int live_lanes = min(32, (n - base + R - 1) / R);
  const int steps = m + live_lanes - 1;
  int last = X[R - 1];  // the band's last row, current column
  // X(i0 - 1, j - 1); lane 0 starts from X(base, 0)
  int diag_in = base == 0 ? 3 : 2;
  auto code_at = [&](int j) {
    return j >= 1 && j <= m ? static_cast<int>(t[j - 1]) : NO_CODE + 1;
  };
  int tc_next = code_at(1 - lane);
  for (int s = 1; s <= steps; ++s) {
    int up = __shfl_up_sync(FULL_MASK, last, 1);
    const int j = s - lane;
    if (lane == 0) up = up_in != nullptr && j <= m ? up_in[j - 1] : 1;
    const int tc = tc_next;
    tc_next = code_at(j + 1);
    if (j >= 1 && j <= m) {
      int d = diag_in, u = up;
#pragma unroll
      for (int r = 0; r < R; ++r) {
        const int x = max(max(d + (qc[r] == tc ? sm : sx), u + iu),
                          X[r] + il) & ~12;
        d = X[r];
        X[r] = x;
        u = x;
        if (x > rb[r]) {
          rb[r] = x | 12;
          rj[r] = j;
        }
      }
      last = u;
      if (up_out != nullptr && lane == 31) up_out[j - 1] = u;
      if (j >= col_lo) {
        // column m - c's first strict maximum over this band's live rows
        int cb = 15, ci = 0;
#pragma unroll
        for (int r = 0; r < R; ++r) {
          if (i0 + r <= n && X[r] > cb) {
            cb = X[r] | 12;
            ci = i0 + r;
          }
        }
        if (ci != 0) best.consider(cb >> 4, 2 * (m - j), ci, cb & 3);
      }
    }
    diag_in = up;
  }
#pragma unroll
  for (int r = 0; r < R; ++r)
    if (rj[r] != 0)
      best.consider(rb[r] >> 4, 2 * (n - (i0 + r)) + 1, rj[r], rb[r] & 3);
}

template <int R>
__device__ __forceinline__ void pair_dp(const Args& a, int lane, int n, int m,
                                        const int8_t* q, const int8_t* t,
                                        int* row, Best& best) {
  for (int base = 0; base < n; base += 32 * R) {
    const int* up_in = base == 0 ? nullptr : row;
    int* up_out = base + 32 * R < n ? row : nullptr;
    sweep<R>(a, lane, n, m, q, t, base, up_in, up_out, best);
    __syncwarp();  // the strip's last row, seen by the next strip
  }
}

__global__ void __launch_bounds__(WARPS * 32) evaluate_kernel(Args a) {
  const int lane = threadIdx.x & 31;
  const int p = blockIdx.x * WARPS + (threadIdx.x >> 5);
  if (p >= a.P) return;  // the whole warp
  const int* mp = a.meta + static_cast<size_t>(p) * META;
  const int n = mp[1], m = mp[3];
  const int8_t* q = a.codes + mp[0];
  const int8_t* t = a.codes + mp[2];
  int* row = mp[4] >= 0 ? a.scratch + mp[4] : nullptr;
  // column m's row 0: the least candidate of H 0
  Best best{0, 0, 0, 1};
  if (n <= 64) pair_dp<2>(a, lane, n, m, q, t, row, best);
  else if (n <= 128) pair_dp<4>(a, lane, n, m, q, t, row, best);
  else if (n <= 192) pair_dp<6>(a, lane, n, m, q, t, row, best);
  else if (n <= 256) pair_dp<8>(a, lane, n, m, q, t, row, best);
  else if (n <= 384) pair_dp<12>(a, lane, n, m, q, t, row, best);
  else if (n <= 512) pair_dp<16>(a, lane, n, m, q, t, row, best);
  else if (n <= 768) pair_dp<24>(a, lane, n, m, q, t, row, best);
  else pair_dp<32>(a, lane, n, m, q, t, row, best);
  for (int o = 16; o > 0; o >>= 1) {
    const int h = __shfl_down_sync(FULL_MASK, best.h, o);
    const int s = __shfl_down_sync(FULL_MASK, best.scan, o);
    const int w = __shfl_down_sync(FULL_MASK, best.at, o);
    const int f = __shfl_down_sync(FULL_MASK, best.flags, o);
    best.consider(h, s, w, f);
  }
  if (lane != 0) return;
  const int c = best.scan >> 1;
  const bool is_row = best.scan & 1;
  int* o = a.out + static_cast<size_t>(p) * 6;
  o[0] = best.h;
  o[1] = is_row ? n - c : best.at;
  o[2] = is_row ? best.at : m - c;
  o[3] = c;
  o[4] = best.flags & 1;
  o[5] = (best.flags >> 1) & 1;
}

}  // namespace

// buf: [P, 5] int32 per-pair (q_off, n, t_off, m, s_off) followed by the
// int8 codes the offsets index (from buf + 20 P); out int32 [P, 6];
// scratch int32, a row of m a pair with n > 1024 at its s_off (may be
// null where no pair has one). Every pair has n, m >= 1. All on the
// card. Returns the launch's CUDA error, or 0.
extern "C" int evaluate_launch(const void* buf, int P, int max_clip,
                               int match, int mismatch, int ind, void* out,
                               void* scratch, void* stream) {
  if (P == 0) return 0;
  if (P < 0 || max_clip < 0) return static_cast<int>(cudaErrorInvalidValue);
  const Args a{static_cast<const int*>(buf),
               static_cast<const int8_t*>(buf) + static_cast<size_t>(P) * META
                   * sizeof(int),
               P, max_clip, 16 * match + 8, 16 * mismatch + 8, 16 * ind + 4,
               16 * ind, static_cast<int*>(out), static_cast<int*>(scratch)};
  const unsigned grid = static_cast<unsigned>((P + WARPS - 1) / WARPS);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  evaluate_kernel<<<grid, WARPS * 32, 0, s>>>(a);
  return static_cast<int>(cudaGetLastError());
}
