// Batched Gotoh affine-gap DP (Smith-Waterman and its overlap / fit /
// extend variants): best cell (score, qend, tend) of each query/target
// pair. Replaces gappadder_tpu/ops/sw_pallas.py::sw_batch_pallas and
// computes exactly what gappadder_tpu/ops/sw_xla.py::sw_batch computes.
//
// Bound on this card: int32 ALU instruction throughput, not bytes. A
// pair reads at most Lq + Lt bytes and writes 12, against 11 plain
// int32 operations for each of its live cells: H - go once (it feeds
// both the E of the cell to the right and the F below), E and F one
// subtract and one max each, the substitution score a compare and a
// select, diag + s, and three maxes (diag vs E, vs F, vs 0).
//
// Design: one warp per pair, several pairs per block, no barrier and no
// shared memory. Lane l holds a band of R consecutive query rows
// (rows lR + 1 .. lR + R), R the least of {2, 4, 8, 10, 16, 32} with
// 32 R >= Lq, and keeps their H and E in registers. The warp sweeps in
// steps: at step s lane l computes column j = s - l for all its rows,
// top to bottom, so F runs down the band inside the lane. The band's
// last-row H and F pass to lane l + 1 by one __shfl_up_sync each per
// step; the H a lane received one step earlier is its first row's
// diagonal. Each lane reads its own column's target code (prefetched a
// step ahead). A pair takes tl + (live lanes) - 1 steps, so each warp
// stops at its own pair's last live step, and lanes idle only while
// the band enters and leaves the sweep (31 steps of tl + 31), against
// one thread per row idling outside its row's band of anti-diagonals
// before.
//
// Tie-break (exact): score descending, then diagonal d = i + j
// ascending, then row i ascending. A lane visits its cells column by
// column, rows ascending within a column, which is not the order of d.
// But within one row the columns come in ascending order, so each row
// keeps its own first strict improvement (score, column), and at the
// end each lane folds its rows and the warp its lanes under the full
// (score desc, d asc, i asc) order.
//
// Rows past the pair's query length (the last lanes' bands) are swept
// with the rest and thrown away: they lie below every live row and feed
// none. Columns past tl are not swept. A target longer than its row
// (tl > Lt) is swept as the plain version sweeps it: codes past Lt are
// the sentinel, and cells with i + j > Lq + Lt are never candidates.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int NEG = -(1 << 28);
constexpr int SENTINEL = 127;
constexpr int NO_MATCH = 1 << 10;  // a query code no target code equals
constexpr int WARPS = 4;           // pairs per block
constexpr unsigned FULL_MASK = 0xffffffffu;
enum Mode { LOCAL = 0, OVERLAP = 1, FIT = 2, EXTEND = 3 };

struct Args {
  const int8_t* q;
  const int* qlen;
  const int8_t* t;
  const int* tlen;
  int B, Lq, Lt, match, mismatch, go, ge, end_slack;
  int* score;
  int* qend;
  int* tend;
};

__device__ __forceinline__ bool better(int h1, int d1, int i1,
                                       int h2, int d2, int i2) {
  if (h1 != h2) return h1 > h2;
  if (d1 != d2) return d1 < d2;
  return i1 < i2;
}

// One pair's DP by one warp; folds this lane's rows into (bh, bd, bi).
template <int MODE, int R, bool CLIP>
__device__ __forceinline__ void sweep(const Args& a, int b, int lane, int ql,
                                      int qrows, int tl, int& bh, int& bd,
                                      int& bi) {
  const int i0 = lane * R + 1;  // first row of this lane's band
  const int go = a.go, ge = a.ge;
  const int match = a.match, mismatch = a.mismatch;
  int H[R], E[R], qc[R], rh[R], rj[R];
  unsigned cand_rows = 0;  // rows whose every cell is a candidate
#pragma unroll
  for (int r = 0; r < R; ++r) {
    const int i = i0 + r;
    const int code = i <= a.Lq
        ? static_cast<int>(a.q[static_cast<size_t>(b) * a.Lq + i - 1])
        : SENTINEL;
    qc[r] = code < 4 ? code : NO_MATCH;
    // H[i][0], the left boundary column
    int col0 = NEG;
    if (i <= qrows) {
      if (MODE == LOCAL || MODE == OVERLAP) col0 = 0;
      else if (MODE == FIT) col0 = -(go + (i - 1) * ge);
    }
    H[r] = col0;
    E[r] = NEG;
    rh[r] = NEG;
    rj[r] = 0;
    if ((MODE == OVERLAP && i >= ql - a.end_slack) ||
        (MODE == FIT && i == ql))
      cand_rows |= 1u << r;
  }

  // cells with j > Lq + Lt - 1 have i + j > Lq + Lt for every row
  const int tlc = CLIP ? min(tl, a.Lq + a.Lt - 1) : tl;
  const int t_end = min(tlc, a.Lt);  // columns whose code is read
  const int8_t* tb = a.t + static_cast<size_t>(b) * a.Lt;
  auto code_at = [&](int j) {
    return j >= 1 && j <= t_end ? static_cast<int>(tb[j - 1]) : SENTINEL;
  };
  const int live_lanes = min(32, (qrows + R - 1) / R);
  const int steps = tlc + live_lanes - 1;
  // H[0][j] for 1 <= j <= tl; H[0][0] = 0 in every mode
  const int row0 = MODE == EXTEND ? NEG : 0;
  int last_h = H[R - 1], last_f = NEG;  // band's last row, current column
  int diag_in = 0;                      // H[i0 - 1][j - 1]
  int tc_next = code_at(1 - lane);
  for (int s = 1; s <= steps; ++s) {
    int up_h = __shfl_up_sync(FULL_MASK, last_h, 1);
    int up_f = __shfl_up_sync(FULL_MASK, last_f, 1);
    if (lane == 0) {
      up_h = row0;
      up_f = NEG;
    }
    const int j = s - lane;
    const int tc = tc_next;
    tc_next = code_at(j + 1);
    if (j >= 1 && j <= tlc) {
      int diag = diag_in, uh = up_h, uf = up_f;
      const bool col_cand = MODE == OVERLAP && j >= tl - a.end_slack;
      // rows r <= rlim have i + j <= Lq + Lt
      const int rlim = CLIP ? a.Lq + a.Lt - j - i0 : R;
#pragma unroll
      for (int r = 0; r < R; ++r) {
        const int e = max(H[r] - go, E[r] - ge);
        const int f = max(uh - go, uf - ge);
        int h = max(diag + (qc[r] == tc ? match : mismatch), max(e, f));
        if (MODE == LOCAL) h = max(h, 0);
        diag = H[r];
        H[r] = h;
        E[r] = e;
        uh = h;
        uf = f;
        bool cand = MODE == LOCAL || MODE == EXTEND || col_cand ||
                    ((cand_rows >> r) & 1u);
        if (CLIP) cand = cand && r <= rlim;
        if (cand && h > rh[r]) {
          rh[r] = h;
          rj[r] = j;
        }
      }
      last_h = uh;
      last_f = uf;
    }
    diag_in = up_h;
  }

  // a row that never improved on NEG stays out: it is the initial
  // (NEG, 0, 0) of the reduction
#pragma unroll
  for (int r = 0; r < R; ++r) {
    const int i = i0 + r;
    if (i <= qrows && rh[r] > NEG && better(rh[r], i + rj[r], i, bh, bd, bi)) {
      bh = rh[r];
      bd = i + rj[r];
      bi = i;
    }
  }
}

template <int MODE, int R>
__global__ void __launch_bounds__(WARPS * 32) sw_kernel(Args a) {
  const int lane = threadIdx.x & 31;
  const int b = blockIdx.x * WARPS + (threadIdx.x >> 5);
  if (b >= a.B) return;  // the whole warp
  const int ql = a.qlen[b];
  const int tl = a.tlen[b];
  const int qrows = min(ql, a.Lq);
  int bh = NEG, bd = 0, bi = 0;
  if (qrows > 0 && tl > 0) {
    if (tl > a.Lt) sweep<MODE, R, true>(a, b, lane, ql, qrows, tl, bh, bd, bi);
    else sweep<MODE, R, false>(a, b, lane, ql, qrows, tl, bh, bd, bi);
  }
  // warp reduction under the (score desc, d asc, i asc) order
  for (int o = 16; o > 0; o >>= 1) {
    const int h2 = __shfl_down_sync(FULL_MASK, bh, o);
    const int d2 = __shfl_down_sync(FULL_MASK, bd, o);
    const int i2 = __shfl_down_sync(FULL_MASK, bi, o);
    if (better(h2, d2, i2, bh, bd, bi)) {
      bh = h2;
      bd = d2;
      bi = i2;
    }
  }
  if (lane != 0) return;
  int sc = bh;
  // empty-best fallbacks, per mode
  if (MODE == FIT) {
    const int fb = -(a.go + (ql - 1) * a.ge);  // the all-gap cell H[qlen, 0]
    if (sc < fb) { sc = fb; bi = ql; bd = ql; }
  } else if (sc < 0) {
    sc = 0;
    if (MODE == OVERLAP) { bi = ql; bd = ql; }   // H[qlen, 0]
    else { bi = 0; bd = 0; }                     // the origin
  }
  a.score[b] = sc;
  a.qend[b] = bi;
  a.tend[b] = bd - bi;
}

template <int R>
int launch(const Args& a, int mode, cudaStream_t stream) {
  const unsigned grid = static_cast<unsigned>((a.B + WARPS - 1) / WARPS);
  switch (mode) {
    case LOCAL: sw_kernel<LOCAL, R><<<grid, WARPS * 32, 0, stream>>>(a); break;
    case OVERLAP: sw_kernel<OVERLAP, R><<<grid, WARPS * 32, 0, stream>>>(a); break;
    case FIT: sw_kernel<FIT, R><<<grid, WARPS * 32, 0, stream>>>(a); break;
    case EXTEND: sw_kernel<EXTEND, R><<<grid, WARPS * 32, 0, stream>>>(a); break;
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// q int8 [B, Lq], t int8 [B, Lt], qlen / tlen int32 [B], outputs int32
// [B], all contiguous on the card; Lq <= 1024. Returns the launch's CUDA
// error, or 0.
extern "C" int sw_batch_launch(const void* q, const void* qlen,
                               const void* t, const void* tlen, int B,
                               int Lq, int Lt, int match, int mismatch,
                               int go, int ge, int mode, int end_slack,
                               void* score, void* qend, void* tend,
                               void* stream) {
  if (B == 0) return 0;
  if (B < 0 || Lq < 0 || Lq > 32 * 32 || Lt < 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const Args a{static_cast<const int8_t*>(q), static_cast<const int*>(qlen),
               static_cast<const int8_t*>(t), static_cast<const int*>(tlen),
               B, Lq, Lt, match, mismatch, go, ge, end_slack,
               static_cast<int*>(score), static_cast<int*>(qend),
               static_cast<int*>(tend)};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (Lq <= 32 * 2) return launch<2>(a, mode, s);
  if (Lq <= 32 * 4) return launch<4>(a, mode, s);
  if (Lq <= 32 * 8) return launch<8>(a, mode, s);
  if (Lq <= 32 * 10) return launch<10>(a, mode, s);
  if (Lq <= 32 * 16) return launch<16>(a, mode, s);
  return launch<32>(a, mode, s);
}
