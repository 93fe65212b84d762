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
//
// Queries longer than 32 x 32 rows: the warp sweeps the query in strips
// of 32 R = 1024 rows (R = 32), one after another. Each strip but the
// pair's last writes its last row's H and F, column by column, to a
// per-pair scratch row in device memory (lane 31 writes column j right
// after computing it); lane 0 of the next strip reads that row as its
// upper neighbour where the first strip takes row 0, and H[base][0],
// the left boundary of the row above the strip, as its first diagonal.
// Lane 31 writes column j at step j + 31, after lane 0 read it at step
// j and only through values that depend on that read, so one row is
// read and rewritten in place. Every boundary and candidate rule uses
// the global row index; each row keeps its own first strict improvement
// and the strips fold into the lane's running best under the full order,
// so the order of the strips does not matter. Queries of at most 1024
// rows take exactly the one-strip kernels of before.

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
  int2* scratch;  // [B, Lq + Lt] (H, F) of a strip's last row, or null
};

__device__ __forceinline__ bool better(int h1, int d1, int i1,
                                       int h2, int d2, int i2) {
  if (h1 != h2) return h1 > h2;
  if (d1 != d2) return d1 < d2;
  return i1 < i2;
}

// H[i][0], the left boundary column, for a row 1 <= i <= qrows
template <int MODE>
__device__ __forceinline__ int col0_of(int i, int go, int ge) {
  if (MODE == LOCAL || MODE == OVERLAP) return 0;
  if (MODE == FIT) return -(go + (i - 1) * ge);
  return NEG;
}

// One strip of one pair's DP by one warp: rows base + 1 .. base + 32 R.
// `up_in` holds the row above the strip (null: row 0), `up_out` takes
// the strip's last row (null: the pair's last strip). Folds this lane's
// rows into (bh, bd, bi).
template <int MODE, int R, bool CLIP>
__device__ __forceinline__ void sweep(const Args& a, int b, int lane, int ql,
                                      int qrows, int tl, int base,
                                      const int2* up_in, int2* up_out,
                                      int& bh, int& bd, int& bi) {
  const int i0 = base + lane * R + 1;  // first row of this lane's band
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
    H[r] = i <= qrows ? col0_of<MODE>(i, go, ge) : NEG;
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
  const int live_lanes = min(32, (qrows - base + R - 1) / R);
  const int steps = tlc + live_lanes - 1;
  // H[0][j] for 1 <= j <= tl; H[0][0] = 0 in every mode
  const int row0 = MODE == EXTEND ? NEG : 0;
  int last_h = H[R - 1], last_f = NEG;  // band's last row, current column
  // H[i0 - 1][j - 1]; lane 0 starts from H[base][0]
  int diag_in = base == 0 ? 0 : col0_of<MODE>(base, go, ge);
  int tc_next = code_at(1 - lane);
  for (int s = 1; s <= steps; ++s) {
    int up_h = __shfl_up_sync(FULL_MASK, last_h, 1);
    int up_f = __shfl_up_sync(FULL_MASK, last_f, 1);
    const int j = s - lane;
    if (lane == 0) {
      up_h = row0;
      up_f = NEG;
      if (up_in != nullptr && j <= tlc) {
        const int2 u = up_in[j - 1];
        up_h = u.x;
        up_f = u.y;
      }
    }
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
      if (up_out != nullptr && lane == 31) up_out[j - 1] = make_int2(uh, uf);
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

// STRIPS: the query may be longer than 32 R rows (a.scratch is set)
template <int MODE, int R, bool STRIPS>
__global__ void __launch_bounds__(WARPS * 32) sw_kernel(Args a) {
  const int lane = threadIdx.x & 31;
  const int b = blockIdx.x * WARPS + (threadIdx.x >> 5);
  if (b >= a.B) return;  // the whole warp
  const int ql = a.qlen[b];
  const int tl = a.tlen[b];
  const int qrows = min(ql, a.Lq);
  int bh = NEG, bd = 0, bi = 0;
  if (qrows > 0 && tl > 0) {
    if constexpr (STRIPS) {
      int2* row = a.scratch + static_cast<size_t>(b) * (a.Lq + a.Lt);
      for (int base = 0; base < qrows; base += 32 * R) {
        const int2* up_in = base == 0 ? nullptr : row;
        int2* up_out = base + 32 * R < qrows ? row : nullptr;
        if (tl > a.Lt)
          sweep<MODE, R, true>(a, b, lane, ql, qrows, tl, base, up_in, up_out,
                               bh, bd, bi);
        else
          sweep<MODE, R, false>(a, b, lane, ql, qrows, tl, base, up_in,
                                up_out, bh, bd, bi);
        __syncwarp();  // the strip's last row, seen by the next strip
      }
    } else if (tl > a.Lt) {
      sweep<MODE, R, true>(a, b, lane, ql, qrows, tl, 0, nullptr, nullptr, bh,
                           bd, bi);
    } else {
      sweep<MODE, R, false>(a, b, lane, ql, qrows, tl, 0, nullptr, nullptr, bh,
                            bd, bi);
    }
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

template <int R, bool STRIPS = false>
int launch(const Args& a, int mode, cudaStream_t stream) {
  const unsigned grid = static_cast<unsigned>((a.B + WARPS - 1) / WARPS);
  switch (mode) {
    case LOCAL:
      sw_kernel<LOCAL, R, STRIPS><<<grid, WARPS * 32, 0, stream>>>(a);
      break;
    case OVERLAP:
      sw_kernel<OVERLAP, R, STRIPS><<<grid, WARPS * 32, 0, stream>>>(a);
      break;
    case FIT:
      sw_kernel<FIT, R, STRIPS><<<grid, WARPS * 32, 0, stream>>>(a);
      break;
    case EXTEND:
      sw_kernel<EXTEND, R, STRIPS><<<grid, WARPS * 32, 0, stream>>>(a);
      break;
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// q int8 [B, Lq], t int8 [B, Lt], qlen / tlen int32 [B], outputs int32
// [B], all contiguous on the card; for Lq > 1024, scratch int32
// [B, Lq + Lt, 2] (uninitialised; ignored, and may be null, otherwise).
// Returns the launch's CUDA error, or 0.
extern "C" int sw_batch_launch(const void* q, const void* qlen,
                               const void* t, const void* tlen, int B,
                               int Lq, int Lt, int match, int mismatch,
                               int go, int ge, int mode, int end_slack,
                               void* score, void* qend, void* tend,
                               void* scratch, void* stream) {
  if (B == 0) return 0;
  if (B < 0 || Lq < 0 || Lt < 0 || (Lq > 32 * 32 && scratch == nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  const Args a{static_cast<const int8_t*>(q), static_cast<const int*>(qlen),
               static_cast<const int8_t*>(t), static_cast<const int*>(tlen),
               B, Lq, Lt, match, mismatch, go, ge, end_slack,
               static_cast<int*>(score), static_cast<int*>(qend),
               static_cast<int*>(tend), static_cast<int2*>(scratch)};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (Lq <= 32 * 2) return launch<2>(a, mode, s);
  if (Lq <= 32 * 4) return launch<4>(a, mode, s);
  if (Lq <= 32 * 8) return launch<8>(a, mode, s);
  if (Lq <= 32 * 10) return launch<10>(a, mode, s);
  if (Lq <= 32 * 16) return launch<16>(a, mode, s);
  if (Lq <= 32 * 32) return launch<32>(a, mode, s);
  return launch<32, true>(a, mode, s);
}
