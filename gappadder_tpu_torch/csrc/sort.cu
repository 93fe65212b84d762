// Batched lexicographic sort of int64 key planes, payload planes carried
// along, stable (the input index is the last tie-break). Replaces
// gappadder_tpu/ops/psort.py::_bitonic_call (the Pallas bitonic network
// behind psort.bitonic_sort) and equals the port's plain version, an LSD
// chain of stable torch.sort passes, bit for bit in every plane.
//
// Bound on this card: bytes. A sort has to read every input plane and
// write every output plane at least once, 16 bytes per element and
// plane, and does next to no arithmetic per byte (a few int64 compares
// per element and pass). The design keeps as many passes as it can out
// of device memory:
//
//  * Each row of N elements is padded to n = next power of two and
//    sorted by a bitonic network over (is_pad, key_0 .. key_{K-1},
//    index). Index is unique, so this is a strict total order and the
//    result is the stable order. A pad element (index >= N) sorts after
//    every real element whatever the keys: FULL (0xFFFFFFFF) is a live
//    key value here, so a key sentinel alone would reorder payloads.
//    Keys compare as signed int64: the port holds uint32 limbs and
//    int32 values (negative ones too) in int64, so no bit mapping is
//    needed.
//  * Only the K keys and the index move during the network (8K + 4
//    bytes an element), in a structure-of-arrays scratch [K][B*n] plus
//    [B*n]. Payloads never move until the end.
//  * Shared-memory part: one block per tile of T elements (T a power of
//    two, tile bytes <= 112 KB so two blocks fit an SM) runs every pass
//    with partner distance d < T in shared memory: the whole local sort
//    up to size T first, then, for each larger merge stage, the tail
//    of passes with d < T.
//  * Global part: one launch per pass with d >= T, over every row and
//    tile at once, so a single long row still spreads over all SMs.
//    A comparator writes only when it swaps.
//  * A last kernel writes every output plane (keys and payloads alike)
//    through the final permutation, reading the inputs with their own
//    row and element strides, so strided planes need no copy first.
//
// Per row of n = 2^m with T = 2^t: one local launch, (m - t)(m - t + 1)/2
// global passes, m - t merge launches and one permutation launch.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int MAX_KEYS = 6;
constexpr int MAX_PLANES = 8;
constexpr int LOCAL_THREADS = 512;
constexpr int GLOBAL_THREADS = 256;
constexpr size_t TILE_BYTES = 112 * 1024;

struct Planes {
  const int64_t* in[MAX_PLANES];
  int64_t* out[MAX_PLANES];
  int64_t rs[MAX_PLANES];  // row stride of each input plane, in elements
  int64_t es[MAX_PLANES];  // element stride of each input plane
};

// a sorts strictly before b in the order (is_pad, keys, index)
template <int K>
__device__ __forceinline__ bool before(const int64_t (&ka)[K], int ia,
                                       const int64_t (&kb)[K], int ib,
                                       int N) {
  const bool pa = ia >= N, pb = ib >= N;
  if (pa != pb) return pb;
  if (!pa) {
#pragma unroll
    for (int k = 0; k < K; ++k) {
      if (ka[k] != kb[k]) return ka[k] < kb[k];
    }
  }
  return ia < ib;
}

// partner pair of comparator c at distance d: (i, i + d)
__device__ __forceinline__ int64_t low_of(int64_t c, int64_t d) {
  return ((c & ~(d - 1)) << 1) | (c & (d - 1));
}

// Sort passes with d < T inside one tile of T elements in shared
// memory. stage == 0: the full local sort (sizes 2..T), reading the
// inputs; stage > T: the passes d = T/2 .. 1 of that merge stage,
// reading the scratch. Writes the tile back to the scratch.
template <int K>
__global__ void psort_local(Planes p, int N, int64_t n, int T, int64_t stage,
                            int64_t* __restrict__ wk,
                            int* __restrict__ widx) {
  extern __shared__ unsigned char smem_raw[];
  int64_t* sk = reinterpret_cast<int64_t*>(smem_raw);  // [K][T]
  int* si = reinterpret_cast<int*>(sk + static_cast<int64_t>(K) * T);
  const int64_t tiles_per_row = n / T;
  const int64_t row = blockIdx.x / tiles_per_row;
  const int64_t base = (blockIdx.x % tiles_per_row) * T;  // within the row
  const int64_t total = static_cast<int64_t>(gridDim.x / tiles_per_row) * n;

  for (int e = threadIdx.x; e < T; e += blockDim.x) {
    const int64_t j = base + e;
    if (stage == 0) {
      si[e] = static_cast<int>(j);
#pragma unroll
      for (int k = 0; k < K; ++k) {
        sk[k * T + e] = j < N ? p.in[k][row * p.rs[k] + j * p.es[k]] : 0;
      }
    } else {
      const int64_t g = row * n + j;
      si[e] = widx[g];
#pragma unroll
      for (int k = 0; k < K; ++k) sk[k * T + e] = wk[k * total + g];
    }
  }
  __syncthreads();

  const int64_t s_lo = stage == 0 ? 2 : stage;
  const int64_t s_hi = stage == 0 ? T : stage;
  for (int64_t s = s_lo; s <= s_hi; s <<= 1) {
    for (int64_t d = (s < T ? s : T) >> 1; d >= 1; d >>= 1) {
      for (int c = threadIdx.x; c < T / 2; c += blockDim.x) {
        const int a = static_cast<int>(low_of(c, d));
        const int b = a + static_cast<int>(d);
        const bool asc = ((base + a) & s) == 0;
        int64_t ka[K], kb[K];
#pragma unroll
        for (int k = 0; k < K; ++k) {
          ka[k] = sk[k * T + a];
          kb[k] = sk[k * T + b];
        }
        const int ia = si[a], ib = si[b];
        const bool swap = asc ? before<K>(kb, ib, ka, ia, N)
                              : before<K>(ka, ia, kb, ib, N);
        if (swap) {
#pragma unroll
          for (int k = 0; k < K; ++k) {
            sk[k * T + a] = kb[k];
            sk[k * T + b] = ka[k];
          }
          si[a] = ib;
          si[b] = ia;
        }
      }
      __syncthreads();
    }
  }

  for (int e = threadIdx.x; e < T; e += blockDim.x) {
    const int64_t g = row * n + base + e;
    widx[g] = si[e];
#pragma unroll
    for (int k = 0; k < K; ++k) wk[k * total + g] = sk[k * T + e];
  }
}

// One bitonic pass with partner distance d >= T over every row.
template <int K>
__global__ void psort_global(int N, int64_t n, int64_t comparators,
                             int64_t total, int64_t stage, int64_t d,
                             int64_t* __restrict__ wk,
                             int* __restrict__ widx) {
  const int64_t c = static_cast<int64_t>(blockIdx.x) * blockDim.x +
                    threadIdx.x;
  if (c >= comparators) return;
  const int64_t half = n >> 1;
  const int64_t row = c / half;
  const int64_t a = low_of(c % half, d);
  const int64_t ga = row * n + a, gb = ga + d;
  const bool asc = (a & stage) == 0;
  int64_t ka[K], kb[K];
#pragma unroll
  for (int k = 0; k < K; ++k) {
    ka[k] = wk[k * total + ga];
    kb[k] = wk[k * total + gb];
  }
  const int ia = widx[ga], ib = widx[gb];
  const bool swap = asc ? before<K>(kb, ib, ka, ia, N)
                        : before<K>(ka, ia, kb, ib, N);
  if (swap) {
#pragma unroll
    for (int k = 0; k < K; ++k) {
      wk[k * total + ga] = kb[k];
      wk[k * total + gb] = ka[k];
    }
    widx[ga] = ib;
    widx[gb] = ia;
  }
}

// out[p][row, j] = in[p][row, idx[row, j]] for every plane p and j < N.
__global__ void psort_permute(Planes p, int planes, int N, int64_t n,
                              int64_t count, const int* __restrict__ widx) {
  const int64_t t = static_cast<int64_t>(blockIdx.x) * blockDim.x +
                    threadIdx.x;
  if (t >= count) return;
  const int64_t row = t / N, j = t % N;
  const int64_t src = widx[row * n + j];
  for (int q = 0; q < planes; ++q) {
    p.out[q][t] = p.in[q][row * p.rs[q] + src * p.es[q]];
  }
}

int tile_for(int keys, int64_t n) {
  const size_t per = 8 * static_cast<size_t>(keys) + 4;
  int64_t T = 1;
  while (T * 2 <= n && (T * 2) * per <= TILE_BYTES) T *= 2;
  return static_cast<int>(T);
}

template <int K>
int run(const Planes& p, int planes, int B, int N, int64_t n, void* wk_,
        void* widx_, cudaStream_t stream) {
  int64_t* wk = static_cast<int64_t*>(wk_);
  int* widx = static_cast<int*>(widx_);
  const int T = tile_for(K, n);
  const size_t smem = static_cast<size_t>(T) * (8 * K + 4);
  if (smem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(
        psort_local<K>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  const int64_t total = static_cast<int64_t>(B) * n;
  const unsigned tiles = static_cast<unsigned>(total / T);
  const int lthreads = T / 2 < LOCAL_THREADS ? (T / 2 > 32 ? T / 2 : 32)
                                             : LOCAL_THREADS;
  psort_local<K><<<tiles, lthreads, smem, stream>>>(p, N, n, T, 0, wk, widx);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  const int64_t comparators = total / 2;
  const unsigned gblocks =
      static_cast<unsigned>((comparators + GLOBAL_THREADS - 1) /
                            GLOBAL_THREADS);
  for (int64_t s = 2 * static_cast<int64_t>(T); s <= n; s <<= 1) {
    for (int64_t d = s >> 1; d >= T; d >>= 1) {
      psort_global<K><<<gblocks, GLOBAL_THREADS, 0, stream>>>(
          N, n, comparators, total, s, d, wk, widx);
      err = cudaGetLastError();
      if (err != cudaSuccess) return static_cast<int>(err);
    }
    psort_local<K><<<tiles, lthreads, smem, stream>>>(p, N, n, T, s, wk,
                                                       widx);
    err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  const int64_t count = static_cast<int64_t>(B) * N;
  const unsigned pblocks =
      static_cast<unsigned>((count + GLOBAL_THREADS - 1) / GLOBAL_THREADS);
  psort_permute<<<pblocks, GLOBAL_THREADS, 0, stream>>>(p, planes, N, n,
                                                        count, widx);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// desc: host int64 [4 * planes] = input pointers, output pointers, row
// strides, element strides; the first `keys` planes are the keys. wk is
// device scratch int64 [keys, B, n], widx int32 [B, n], n = the next
// power of two >= N. Returns the first CUDA error of the launches, or 0.
extern "C" int psort_launch(const void* desc, int keys, int planes, int B,
                            int N, void* wk, void* widx, void* stream) {
  if (keys < 1 || keys > MAX_KEYS || planes < keys || planes > MAX_PLANES)
    return static_cast<int>(cudaErrorInvalidValue);
  if (B == 0 || N == 0) return 0;
  const int64_t* d = static_cast<const int64_t*>(desc);
  Planes p{};
  for (int q = 0; q < planes; ++q) {
    p.in[q] = reinterpret_cast<const int64_t*>(d[q]);
    p.out[q] = reinterpret_cast<int64_t*>(d[planes + q]);
    p.rs[q] = d[2 * planes + q];
    p.es[q] = d[3 * planes + q];
  }
  int64_t n = 1;
  while (n < N) n <<= 1;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (keys) {
    case 1: return run<1>(p, planes, B, N, n, wk, widx, s);
    case 2: return run<2>(p, planes, B, N, n, wk, widx, s);
    case 3: return run<3>(p, planes, B, N, n, wk, widx, s);
    case 4: return run<4>(p, planes, B, N, n, wk, widx, s);
    case 5: return run<5>(p, planes, B, N, n, wk, widx, s);
    default: return run<6>(p, planes, B, N, n, wk, widx, s);
  }
}
