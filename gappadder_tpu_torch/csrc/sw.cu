// Batched Gotoh affine-gap DP (Smith-Waterman and its overlap / fit /
// extend variants): best cell (score, qend, tend) of each query/target
// pair. Replaces gappadder_tpu/ops/sw_pallas.py::sw_batch_pallas and
// computes exactly what gappadder_tpu/ops/sw_xla.py::sw_batch computes.
//
// Design: one thread block per pair, one thread per query row i. The
// block sweeps the DP by anti-diagonal d = i + j; on each diagonal
// thread i computes cell (i, d - i). Its own H and E of the previous
// diagonal stay in registers; the row above's H and F of the previous
// diagonal come through a double-buffered shared array (one barrier
// per diagonal), and the row above's H two diagonals back is the value
// received one step earlier. The target is staged once in shared
// memory and read directly: the pre-reversed windows of the TPU kernel
// existed only because Mosaic has no dynamic slices.
//
// Bound on this card: int32 ALU instruction throughput, not bytes. A
// pair reads at most Lq + Lt bytes and writes 12, against 11 plain
// int32 operations for each of its Lq x Lt cells: H - go once (it feeds
// both the E of the cell to the right and the F of the cell below),
// E and F one subtract and one max each, the substitution score a
// compare and a select, diag + s, and three maxes (diag vs E, vs F, vs
// 0). The design spends no instruction on memory traffic inside the
// sweep (registers + one shared load pair per cell), stops each pair at
// its own last live diagonal instead of the padded one, and keeps a
// running best per thread with one block reduction at the end. Not yet
// used: DPX instructions, whose fused add-max (__viaddmax_s32) and
// 3-way max (__vimax3_s32) would cut those 11 instructions further,
// and packed 16-bit lanes.
//
// Tie-break (exact): score descending, then diagonal ascending, then
// row ascending.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int NEG = -(1 << 28);
constexpr int SENTINEL = 127;
enum Mode { LOCAL = 0, OVERLAP = 1, FIT = 2, EXTEND = 3 };

__device__ __forceinline__ bool better(int h1, int d1, int i1,
                                       int h2, int d2, int i2) {
  if (h1 != h2) return h1 > h2;
  if (d1 != d2) return d1 < d2;
  return i1 < i2;
}

__global__ void sw_kernel(const int8_t* __restrict__ q,
                          const int* __restrict__ qlen,
                          const int8_t* __restrict__ t,
                          const int* __restrict__ tlen, int Lq, int Lt,
                          int match, int mismatch, int go, int ge,
                          int mode, int end_slack, int* __restrict__ score,
                          int* __restrict__ qend, int* __restrict__ tend) {
  extern __shared__ int smem[];
  const int nt = blockDim.x;
  int* sH = smem;                 // [2][nt]  H of the previous diagonal
  int* sF = sH + 2 * nt;          // [2][nt]  F of the previous diagonal
  int* rh = sF + 2 * nt;          // [32]     per-warp best
  int* rd = rh + 32;
  int* ri = rd + 32;
  int8_t* st = reinterpret_cast<int8_t*>(ri + 32);  // [Lt] target codes

  const int b = blockIdx.x;
  const int tid = threadIdx.x;
  const int i = tid + 1;                    // DP row of this thread
  const int ql = qlen[b];
  const int tl = tlen[b];
  const int8_t* tb = t + static_cast<size_t>(b) * Lt;
  for (int x = tid; x < Lt; x += nt) st[x] = tb[x];

  const int qrows = min(ql, Lq);
  const bool row_ok = i <= qrows;
  const int qi =
      i <= Lq ? static_cast<int>(q[static_cast<size_t>(b) * Lq + i - 1])
              : SENTINEL;
  const bool free_ends = mode == LOCAL || mode == OVERLAP;
  // H[i][0], the left boundary column
  int col0 = NEG;
  if (row_ok) {
    if (free_ends) col0 = 0;
    else if (mode == FIT) col0 = -(go + (i - 1) * ge);
  }

  // own H / E of the previous diagonal (cell (i, j - 1))
  int h1 = i == 1 ? col0 : NEG;
  int e1 = NEG;
  // the row above's H two diagonals back (cell (i - 1, j - 1));
  // H[0][0] = 0 in every mode
  int nh_prev = i == 1 ? 0 : NEG;
  sH[nt + tid] = h1;              // buffer 1 holds diagonal d = 1
  sF[nt + tid] = NEG;

  int bh = NEG, bd = 0;
  const int dmax = min(Lq + Lt, qrows + max(tl, 0));
  __syncthreads();
  for (int d = 2; d <= dmax; ++d) {
    const int j = d - i;
    const int rb = ((d - 1) & 1) * nt;
    int nh, nf;                           // cell (i - 1, j)
    if (i == 1) {
      nh = (mode == EXTEND) ? (j == 0 ? 0 : NEG) : (j <= tl ? 0 : NEG);
      nf = NEG;
    } else {
      nh = sH[rb + tid - 1];
      nf = sF[rb + tid - 1];
    }
    int h, e, f;
    if (row_ok && j >= 1 && j <= tl) {
      e = max(h1 - go, e1 - ge);
      f = max(nh - go, nf - ge);
      const int tc = j - 1 < Lt ? static_cast<int>(st[j - 1]) : SENTINEL;
      const int s = (qi == tc && qi < 4) ? match : mismatch;
      h = max(nh_prev + s, max(e, f));
      if (mode == LOCAL) h = max(h, 0);
      bool cand = true;
      if (mode == OVERLAP)
        cand = (i >= ql - end_slack) || (j >= tl - end_slack);
      else if (mode == FIT)
        cand = i == ql;
      if (cand && h > bh) {
        bh = h;
        bd = d;
      }
    } else {
      h = j == 0 ? col0 : NEG;
      e = NEG;
      f = NEG;
    }
    const int wb = (d & 1) * nt;
    sH[wb + tid] = h;
    sF[wb + tid] = f;
    nh_prev = nh;
    h1 = h;
    e1 = e;
    __syncthreads();
  }

  // block reduction under the (score desc, d asc, i asc) order; a row
  // that never improved on NEG is the initial (NEG, 0, 0)
  int rbh = bh, rbd = bd, rbi = bh == NEG ? 0 : i;
  for (int o = 16; o > 0; o >>= 1) {
    const int h2 = __shfl_down_sync(0xffffffffu, rbh, o);
    const int d2 = __shfl_down_sync(0xffffffffu, rbd, o);
    const int i2 = __shfl_down_sync(0xffffffffu, rbi, o);
    if (better(h2, d2, i2, rbh, rbd, rbi)) {
      rbh = h2;
      rbd = d2;
      rbi = i2;
    }
  }
  const int warp = tid >> 5;
  if ((tid & 31) == 0) {
    rh[warp] = rbh;
    rd[warp] = rbd;
    ri[warp] = rbi;
  }
  __syncthreads();
  if (tid != 0) return;
  int sc = NEG, bi = 0, bdd = 0;
  for (int w = 0; w < (nt >> 5); ++w) {
    if (better(rh[w], rd[w], ri[w], sc, bdd, bi)) {
      sc = rh[w];
      bdd = rd[w];
      bi = ri[w];
    }
  }
  // empty-best fallbacks, per mode
  if (mode == FIT) {
    const int fb = -(go + (ql - 1) * ge);   // the all-gap cell H[qlen, 0]
    if (sc < fb) { sc = fb; bi = ql; bdd = ql; }
  } else if (sc < 0) {
    sc = 0;
    if (mode == OVERLAP) { bi = ql; bdd = ql; }   // H[qlen, 0]
    else { bi = 0; bdd = 0; }                     // the origin
  }
  score[b] = sc;
  qend[b] = bi;
  tend[b] = bdd - bi;
}

}  // namespace

extern "C" int sw_batch_launch(const void* q, const void* qlen,
                               const void* t, const void* tlen, int B,
                               int Lq, int Lt, int match, int mismatch,
                               int go, int ge, int mode, int end_slack,
                               void* score, void* qend, void* tend,
                               void* stream) {
  if (B == 0) return 0;
  int nt = (Lq + 31) / 32 * 32;
  if (nt < 32) nt = 32;
  const size_t smem = static_cast<size_t>(4 * nt + 96) * sizeof(int) + Lt;
  if (smem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(
        sw_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  sw_kernel<<<B, nt, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int8_t*>(q), static_cast<const int*>(qlen),
      static_cast<const int8_t*>(t), static_cast<const int*>(tlen), Lq, Lt,
      match, mismatch, go, ge, mode, end_slack, static_cast<int*>(score),
      static_cast<int*>(qend), static_cast<int*>(tend));
  return static_cast<int>(cudaGetLastError());
}
