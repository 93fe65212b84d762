// Batched lexicographic sort of int64 key planes, payload planes carried
// along, stable (the input index is the last tie-break). Replaces
// gappadder_tpu/ops/psort.py::_bitonic_call (the Pallas bitonic network
// behind psort.bitonic_sort) and equals the port's plain version, an LSD
// chain of stable torch.sort passes, bit for bit in every plane.
//
// Bound on this card: bytes. A sort has to read every input plane and
// write every output plane at least once, 16 bytes per element and
// plane, and does next to no arithmetic per byte (a few int64 compares
// per element and pass). The design is a tiled merge sort that keeps
// the passes over device memory few and each of them a single stream:
//
//  * Elements compare by (key_0 .. key_{K-1}, index) as signed int64
//    keys (the port holds uint32 limbs and int32 values, negative ones
//    too, in int64, so no bit mapping is needed). The index is unique,
//    so this is a strict total order and the result is the stable
//    order. Rows are not padded: elements past N never enter the sort,
//    and a thread's empty register slots hold a sentinel above every
//    real element that is never written.
//  * Tile sort (psort_tiles): one block per tile of T = threads x E
//    consecutive elements of one row, read once through each input
//    plane's own strides (strided planes need no copy). Each thread
//    sorts E elements in registers, then the block merges runs of E,
//    2E, .. in shared memory by merge path: each thread finds where its
//    E outputs start by a binary search along the merge diagonal and
//    merges them serially. Only a row's last tile is short.
//  * Merge passes (psort_merge): runs of T, 2T, .. are merged pairwise,
//    ping-ponging between two scratch buffers, ceil(log2(tiles)) passes
//    in all. Every block owns T consecutive outputs of one row: two
//    warps find its two split points by a 33-way search (each lane
//    probes one point of the diagonal, a ballot narrows the range),
//    the block stages its inputs in shared memory and merges them as
//    the tile sort does. The grid covers every (row, slice) at once, so
//    a single long row still spreads over the card; an odd run out is
//    copied by the same code.
//  * Only the K keys and the int32 index move (8K + 4 bytes an element);
//    the last launch (the tile sort when a row fits one tile, else the
//    last merge pass) writes the key planes from the sorted keys and
//    gathers each payload plane through the final index, so payloads
//    are read once and written once.
//  * Shared memory holds a padding slot after every E elements, so a
//    warp's threads, each reading or writing its own E consecutive
//    elements, hit distinct banks (without it the register exchange
//    and the start of each merge are 16-way bank conflicts).
//  * Tiles are wide (256 threads) unless that grid would hold fewer
//    blocks than half the card's SMs (a single long row, a small
//    batch); then they are narrow (64 threads), for four times the
//    blocks.
//
// Per call: 1 + ceil(log2(ceil(N / T))) launches, T = 2048 (keys <= 3)
// or 1024 wide, a quarter of that narrow.

#include <climits>
#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int MAX_KEYS = 6;
constexpr int MAX_PLANES = 8;
constexpr int WIDE_THREADS = 256;
constexpr int NARROW_THREADS = 64;
constexpr unsigned FULL_MASK = 0xffffffffu;

// elements each thread sorts in registers: fewer when keys are many
template <int K>
constexpr int ELEMS = K <= 3 ? 8 : 4;
template <int K>
constexpr int LOG_ELEMS = K <= 3 ? 3 : 2;

struct Planes {
  const int64_t* in[MAX_PLANES];
  int64_t* out[MAX_PLANES];
  int64_t rs[MAX_PLANES];  // row stride of each input plane, in elements
  int64_t es[MAX_PLANES];  // element stride of each input plane
};

template <int K>
struct Elem {
  int64_t k[K];
  int i;
};

// a sorts strictly before b in the order (keys, index)
template <int K>
__device__ __forceinline__ bool before(const Elem<K>& a, const Elem<K>& b) {
#pragma unroll
  for (int k = 0; k < K; ++k) {
    if (a.k[k] != b.k[k]) return a.k[k] < b.k[k];
  }
  return a.i < b.i;
}

template <int K>
__device__ __forceinline__ Elem<K> sentinel() {
  Elem<K> v;
#pragma unroll
  for (int k = 0; k < K; ++k) v.k[k] = INT64_MAX;
  v.i = INT_MAX;
  return v;
}

// elements in shared memory, structure of arrays: keys [K][cap], index
// [cap]. Element e sits at e + e / E (E = 2^shift, a thread's register
// count), so the threads of a warp reading or writing E consecutive
// elements each hit distinct banks.
template <int K>
struct Smem {
  int64_t* k;
  int* i;
  int cap;
  int shift;
  __device__ __forceinline__ int slot(int e) const { return e + (e >> shift); }
  __device__ __forceinline__ Elem<K> get(int e) const {
    const int x = slot(e);
    Elem<K> v;
#pragma unroll
    for (int q = 0; q < K; ++q) v.k[q] = k[q * cap + x];
    v.i = i[x];
    return v;
  }
  __device__ __forceinline__ void put(int e, const Elem<K>& v) const {
    const int x = slot(e);
#pragma unroll
    for (int q = 0; q < K; ++q) k[q * cap + x] = v.k[q];
    i[x] = v.i;
  }
};

// sorted runs in device memory: keys [K][total], index [total]
template <int K>
struct Runs {
  int64_t* k;
  int* i;
  int64_t total;
  __device__ __forceinline__ Elem<K> get(int64_t g) const {
    Elem<K> v;
#pragma unroll
    for (int q = 0; q < K; ++q) v.k[q] = k[q * total + g];
    v.i = i[g];
    return v;
  }
  __device__ __forceinline__ void put(int64_t g, const Elem<K>& v) const {
#pragma unroll
    for (int q = 0; q < K; ++q) k[q * total + g] = v.k[q];
    i[g] = v.i;
  }
};

template <int K, int E>
__device__ __forceinline__ void sort_registers(Elem<K> (&v)[E]) {
#pragma unroll
  for (int round = 0; round < E; ++round) {
#pragma unroll
    for (int x = round & 1; x + 1 < E; x += 2) {
      if (before<K>(v[x + 1], v[x])) {
        const Elem<K> t = v[x];
        v[x] = v[x + 1];
        v[x + 1] = t;
      }
    }
  }
}

// Merge path: of the first k outputs of merging A (la elements from a)
// and B (lb from b), how many come from A. A goes first on ties.
template <int K>
__device__ __forceinline__ int split_serial(const Smem<K>& s, int a, int la,
                                            int b, int lb, int k) {
  int lo = max(0, k - lb), hi = min(k, la);
  while (lo < hi) {
    const int mid = (lo + hi) >> 1;
    if (before<K>(s.get(b + k - 1 - mid), s.get(a + mid))) hi = mid;
    else lo = mid + 1;
  }
  return lo;
}

// The same search over runs in device memory by one whole warp: each
// round the 32 lanes probe 32 points of the remaining range at once.
template <int K>
__device__ __forceinline__ int split_warp(const Runs<K>& r, int64_t a,
                                          int la, int64_t b, int lb, int k,
                                          int lane) {
  int lo = max(0, k - lb), hi = min(k, la);
  while (lo < hi) {
    const int n = hi - lo;
    const bool wide = n > 32;
    auto probe = [&](int l) {
      return wide ? lo + static_cast<int>(static_cast<int64_t>(l + 1) * n / 33)
                  : lo + l;
    };
    const int pos = probe(lane);
    bool pred = false;
    if (wide || lane < n) pred = before<K>(r.get(b + k - 1 - pos), r.get(a + pos));
    const unsigned m = __ballot_sync(FULL_MASK, pred);
    if (!wide) return m ? lo + __ffs(m) - 1 : hi;
    if (m == 0) {
      lo = probe(31) + 1;
    } else {
      const int f = __ffs(m) - 1;
      const int new_hi = probe(f);
      lo = f ? probe(f - 1) + 1 : lo;
      hi = new_hi;
    }
  }
  return lo;
}

// E consecutive outputs of the merge of A [a, a_end) and B [b, b_end)
template <int K, int E>
__device__ __forceinline__ void merge_serial(const Smem<K>& s, int a,
                                             int a_end, int b, int b_end,
                                             Elem<K> (&out)[E]) {
  Elem<K> ha = sentinel<K>(), hb = sentinel<K>();
  if (a < a_end) ha = s.get(a);
  if (b < b_end) hb = s.get(b);
#pragma unroll
  for (int x = 0; x < E; ++x) {
    const bool take_a = b >= b_end || (a < a_end && !before<K>(hb, ha));
    if (take_a) {
      out[x] = ha;
      if (++a < a_end) ha = s.get(a);
    } else {
      out[x] = hb;
      if (++b < b_end) hb = s.get(b);
    }
  }
}

// Elements [0, count) of s go to positions base.. of the row: into the
// scratch runs, or, in the last launch, into the output planes (keys
// from s, payloads gathered through the index).
template <int K, bool FINAL>
__device__ __forceinline__ void write_out(const Planes& p, int planes, int N,
                                          int64_t row, int base, int count,
                                          const Smem<K>& s,
                                          const Runs<K>& dst) {
  for (int e = threadIdx.x; e < count; e += blockDim.x) {
    const Elem<K> v = s.get(e);
    const int64_t g = row * N + base + e;
    if (FINAL) {
#pragma unroll
      for (int q = 0; q < K; ++q) p.out[q][g] = v.k[q];
      for (int q = K; q < planes; ++q) {
        p.out[q][g] = p.in[q][row * p.rs[q] + v.i * p.es[q]];
      }
    } else {
      dst.put(g, v);
    }
  }
}

// TH x E elements and one padding slot a thread
template <int K, int TH>
__device__ __forceinline__ Smem<K> shared_elems(unsigned char* raw) {
  constexpr int cap = TH * (ELEMS<K> + 1);
  return Smem<K>{reinterpret_cast<int64_t*>(raw),
                 reinterpret_cast<int*>(raw + sizeof(int64_t) * K * cap), cap,
                 LOG_ELEMS<K>};
}

// One block per tile of T elements of one row: sort it in registers
// and shared memory, write the sorted run.
template <int K, int TH, bool FINAL>
__global__ void __launch_bounds__(TH)
    psort_tiles(Planes p, int planes, int N, int tiles, Runs<K> dst) {
  constexpr int E = ELEMS<K>;
  constexpr int T = TH * E;
  extern __shared__ unsigned char smem_raw[];
  const Smem<K> s = shared_elems<K, TH>(smem_raw);
  const int tid = threadIdx.x;
  const int64_t row = blockIdx.x / tiles;
  const int base = static_cast<int>(blockIdx.x % tiles) * T;
  const int nv = min(T, N - base);

  for (int e = tid; e < nv; e += TH) {
    Elem<K> v;
#pragma unroll
    for (int q = 0; q < K; ++q) {
      v.k[q] = p.in[q][row * p.rs[q] + static_cast<int64_t>(base + e) *
                                          p.es[q]];
    }
    v.i = base + e;
    s.put(e, v);
  }
  __syncthreads();
  Elem<K> v[E];
#pragma unroll
  for (int x = 0; x < E; ++x) {
    const int e = tid * E + x;
    v[x] = e < nv ? s.get(e) : sentinel<K>();
  }
  sort_registers<K, E>(v);

  const int o = tid * E;
  for (int L = E; L < nv; L <<= 1) {
    __syncthreads();
#pragma unroll
    for (int x = 0; x < E; ++x) {
      if (o + x < nv) s.put(o + x, v[x]);
    }
    __syncthreads();
    if (o < nv) {
      const int g = o / (2 * L) * (2 * L);
      const int la = min(L, nv - g);
      const int lb = max(0, min(L, nv - g - L));
      const int k = o - g;
      const int a = split_serial<K>(s, g, la, g + L, lb, k);
      merge_serial<K, E>(s, g + a, g + la, g + L + k - a, g + L + lb, v);
    }
  }
  __syncthreads();
#pragma unroll
  for (int x = 0; x < E; ++x) {
    if (o + x < nv) s.put(o + x, v[x]);
  }
  __syncthreads();
  write_out<K, FINAL>(p, planes, N, row, base, nv, s, dst);
}

// One merge pass over every row: runs of L -> runs of 2L. Each block
// writes T consecutive outputs of one row.
template <int K, int TH, bool FINAL>
__global__ void __launch_bounds__(TH)
    psort_merge(Planes p, int planes, int N, int slices, int L, Runs<K> src,
                Runs<K> dst) {
  constexpr int E = ELEMS<K>;
  constexpr int C = TH * E;
  extern __shared__ unsigned char smem_raw[];
  const Smem<K> s = shared_elems<K, TH>(smem_raw);
  int* split = s.i + s.cap;
  const int tid = threadIdx.x;
  const int64_t row = blockIdx.x / slices;
  const int o0 = static_cast<int>(blockIdx.x % slices) * C;
  const int g = o0 / (2 * L) * (2 * L);
  const int la = min(L, N - g);
  const int lb = max(0, min(L, N - g - L));
  const int k0 = o0 - g;
  const int k1 = min(k0 + C, la + lb);
  const int n = k1 - k0;
  const int64_t a_base = row * N + g;
  const int64_t b_base = a_base + L;

  const int warp = tid >> 5;
  if (warp < 2) {
    const int a = split_warp<K>(src, a_base, la, b_base, lb, warp ? k1 : k0,
                                tid & 31);
    if ((tid & 31) == 0) split[warp] = a;
  }
  __syncthreads();
  const int a0 = split[0];
  const int na = split[1] - a0;
  const int nb = n - na;
  const int b0 = k0 - a0;
  for (int e = tid; e < na; e += TH) s.put(e, src.get(a_base + a0 + e));
  for (int e = tid; e < nb; e += TH) s.put(na + e, src.get(b_base + b0 + e));
  __syncthreads();
  Elem<K> v[E];
  const int o = tid * E;
  if (o < n) {
    const int a = split_serial<K>(s, 0, na, na, nb, o);
    merge_serial<K, E>(s, a, na, na + o - a, na + nb, v);
  }
  __syncthreads();
#pragma unroll
  for (int x = 0; x < E; ++x) {
    if (o + x < n) s.put(o + x, v[x]);
  }
  __syncthreads();
  write_out<K, FINAL>(p, planes, N, row, o0, n, s, dst);
}

int sm_count() {
  static int sms = 0;
  if (sms == 0) {
    int dev = 0;
    cudaGetDevice(&dev);
    cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (sms <= 0) sms = 1;
  }
  return sms;
}

template <int K, int TH>
size_t smem_bytes() {
  return static_cast<size_t>(TH) * (ELEMS<K> + 1) * (8 * K + 4) +
         2 * sizeof(int);
}

// Shared memory above 48 KB has to be asked for, once per kernel.
template <int K, int TH>
int allow_smem() {
  static bool done = false;
  const size_t smem = smem_bytes<K, TH>();
  if (done || smem <= 48 * 1024) return 0;
  const void* fns[] = {
      reinterpret_cast<const void*>(psort_tiles<K, TH, false>),
      reinterpret_cast<const void*>(psort_tiles<K, TH, true>),
      reinterpret_cast<const void*>(psort_merge<K, TH, false>),
      reinterpret_cast<const void*>(psort_merge<K, TH, true>)};
  for (const void* f : fns) {
    const cudaError_t err = cudaFuncSetAttribute(
        f, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  done = true;
  return 0;
}

template <int K, int TH>
int run(const Planes& p, int planes, int B, int N, int64_t* wk, int* widx,
        cudaStream_t stream) {
  constexpr int T = TH * ELEMS<K>;
  const size_t smem = smem_bytes<K, TH>();
  int err = allow_smem<K, TH>();
  if (err) return err;
  const int tiles = (N + T - 1) / T;
  if (static_cast<int64_t>(B) * tiles > INT_MAX)
    return static_cast<int>(cudaErrorInvalidValue);
  const unsigned grid = static_cast<unsigned>(B) * tiles;
  const int64_t total = static_cast<int64_t>(B) * N;
  const Runs<K> runs[2] = {{wk, widx, total},
                           {wk + K * total, widx + total, total}};
  if (tiles == 1) {
    psort_tiles<K, TH, true><<<grid, TH, smem, stream>>>(p, planes, N, tiles,
                                                         runs[0]);
    return static_cast<int>(cudaGetLastError());
  }
  psort_tiles<K, TH, false><<<grid, TH, smem, stream>>>(p, planes, N, tiles,
                                                        runs[0]);
  err = static_cast<int>(cudaGetLastError());
  if (err) return err;
  int cur = 0;
  for (int64_t L = T; L < N; L <<= 1) {
    const int l = static_cast<int>(L);
    if (2 * L >= N) {
      psort_merge<K, TH, true><<<grid, TH, smem, stream>>>(
          p, planes, N, tiles, l, runs[cur], runs[cur ^ 1]);
    } else {
      psort_merge<K, TH, false><<<grid, TH, smem, stream>>>(
          p, planes, N, tiles, l, runs[cur], runs[cur ^ 1]);
    }
    err = static_cast<int>(cudaGetLastError());
    if (err) return err;
    cur ^= 1;
  }
  return 0;
}

// wide tiles, unless their grid would leave half the SMs without a block
template <int K>
int dispatch(const Planes& p, int planes, int B, int N, int64_t* wk,
             int* widx, cudaStream_t stream) {
  constexpr int T = WIDE_THREADS * ELEMS<K>;
  const int64_t tiles = (static_cast<int64_t>(N) + T - 1) / T;
  if (2 * B * tiles >= sm_count())
    return run<K, WIDE_THREADS>(p, planes, B, N, wk, widx, stream);
  return run<K, NARROW_THREADS>(p, planes, B, N, wk, widx, stream);
}

}  // namespace

// desc: host int64 [4 * planes] = input pointers, output pointers, row
// strides, element strides; the first `keys` planes are the keys.
// Output planes are contiguous [B, N]. wk is device scratch int64
// [2, keys, B, N] and widx int32 [2, B, N]: two ping-pong buffers of
// sorted runs. Returns the first CUDA error of the launches, or 0.
extern "C" int psort_launch(const void* desc, int keys, int planes, int B,
                            int N, void* wk, void* widx, void* stream) {
  if (keys < 1 || keys > MAX_KEYS || planes < keys || planes > MAX_PLANES ||
      N < 0 || N >= (1 << 30))
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
  int64_t* k = static_cast<int64_t*>(wk);
  int* i = static_cast<int*>(widx);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (keys) {
    case 1: return dispatch<1>(p, planes, B, N, k, i, s);
    case 2: return dispatch<2>(p, planes, B, N, k, i, s);
    case 3: return dispatch<3>(p, planes, B, N, k, i, s);
    case 4: return dispatch<4>(p, planes, B, N, k, i, s);
    case 5: return dispatch<5>(p, planes, B, N, k, i, s);
    default: return dispatch<6>(p, planes, B, N, k, i, s);
  }
}
