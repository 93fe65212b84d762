"""The CUDA sources of the sort, SW, Evaluate, traceback and probe
kernels, run on the CPU.

A card is the only place the kernels run for real (tests/test_torch_gpu.py
holds them to their plain versions there). This file checks the kernels'
own logic (tiles, merge paths, bands of rows, warp hand-offs, the exact
tie-break) on the CPU: each `csrc/*.cu` source is translated to plain
C++ against a small emulation of the CUDA features it uses (one
std::thread per CUDA thread, blocks one after another, __syncthreads and
the warp shuffles, ballots and reductions as barriers, dynamic shared
memory a buffer per block), built with g++ and called through the same
C entry point the wrapper calls, on CPU buffers. It says nothing about
speed, and a kernel that uses a CUDA feature the emulation lacks fails
to build here. Skips where there is no g++.
"""

import ctypes
import re
import shutil
import subprocess

import numpy as np
import pytest
import torch

from gappadder_tpu_torch import probes
from gappadder_tpu_torch.ops import (cuda_build, evaluate_dp, psort, sw_cuda,
                                     sw_host, traceback_dp)
from gappadder_tpu_torch.ops.sw_host import BWA_PARAMS, SWParams
from gappadder_tpu_torch.probes import int16_repro, swprobe
from gappadder_tpu_torch.probes import kernel_experiments as ke
from gappadder_tpu_torch.testcases import (ARGMAX_INPUTS, EVAL_STRIP_ROWS,
                                           INT16_LOOP_INPUTS, SW_EDGE_SHAPES,
                                           SW_STRIP_SHAPES, SWPROBE_INPUTS,
                                           SWPROBE_SHAPES,
                                           TRACEBACK_STRIP_ROWS,
                                           evaluate_test_pairs, probe_input,
                                           sort_case, sw_edge_pairs,
                                           sw_strip_pairs, sw_test_pairs,
                                           traceback_winners)

EMULATION = r"""
#pragma once
#include <atomic>
#include <barrier>
#include <climits>
#include <cstdint>
#include <cstring>
#include <memory>
#include <thread>
#include <vector>

#define __global__
#define __device__
#define __host__
#define __forceinline__ inline
#define __launch_bounds__(...)
#define __restrict__

typedef void* cudaStream_t;
enum cudaError_t { cudaSuccess = 0, cudaErrorInvalidValue = 1 };
enum cudaFuncAttribute { cudaFuncAttributeMaxDynamicSharedMemorySize = 8 };
enum cudaDeviceAttr { cudaDevAttrMultiProcessorCount = 16 };
inline int emu_sms = 132;
extern "C" void emu_set_sms(int n) { emu_sms = n; }
inline cudaError_t cudaGetLastError() { return cudaSuccess; }
inline cudaError_t cudaFuncSetAttribute(const void*, cudaFuncAttribute, int) {
  return cudaSuccess;
}
// the current device: set by cudaSetDevice, which counts its calls
inline int emu_device = 0, emu_device_sets = 0;
extern "C" int emu_get_device() { return emu_device; }
extern "C" int emu_set_device_calls() { return emu_device_sets; }
inline cudaError_t cudaGetDevice(int* d) { *d = emu_device; return cudaSuccess; }
inline cudaError_t cudaSetDevice(int d) {
  emu_device = d;
  ++emu_device_sets;
  return cudaSuccess;
}
// emu_set_sms(0) makes the SM count's query fail
inline cudaError_t cudaDeviceGetAttribute(int* v, cudaDeviceAttr, int) {
  if (emu_sms <= 0) return cudaErrorInvalidValue;
  *v = emu_sms;
  return cudaSuccess;
}

struct U3 { unsigned x = 0, y = 0, z = 0; };
inline thread_local U3 threadIdx, blockIdx, blockDim, gridDim;

namespace emu {
struct Warp { std::barrier<> bar{32}; uint64_t slot[32]; };
struct Block {
  std::unique_ptr<std::barrier<>> bar;
  std::vector<std::unique_ptr<Warp>> warps;
  std::vector<unsigned char> smem;
};
inline thread_local Block* blk = nullptr;
inline unsigned char* dyn_smem() { return blk->smem.data(); }
inline Warp& warp() { return *blk->warps[threadIdx.x / 32]; }
inline int lane() { return threadIdx.x % 32; }

template <class... P, class... A>
void launch(unsigned grid, unsigned block, size_t smem, cudaStream_t,
            void (*k)(P...), A... args) {
  for (unsigned b = 0; b < grid; ++b) {
    Block B;
    B.bar = std::make_unique<std::barrier<>>(block);
    for (unsigned w = 0; w < (block + 31) / 32; ++w)
      B.warps.push_back(std::make_unique<Warp>());
    B.smem.assign(smem + 64, 0xA5);  // garbage, as on a card
    std::vector<std::thread> ts;
    for (unsigned t = 0; t < block; ++t)
      ts.emplace_back([&, t] {
        threadIdx.x = t; blockIdx.x = b; blockDim.x = block; gridDim.x = grid;
        blk = &B;
        k(args...);
        // an exited thread no longer holds up its block or its warp
        B.bar->arrive_and_drop();
        B.warps[t / 32]->bar.arrive_and_drop();
      });
    for (auto& th : ts) th.join();
  }
}
template <class T> T exchange(T v, int src) {
  Warp& w = warp();
  uint64_t bits = 0;
  std::memcpy(&bits, &v, sizeof(T));
  w.slot[lane()] = bits;
  w.bar.arrive_and_wait();
  T r;
  std::memcpy(&r, &w.slot[src], sizeof(T));
  w.bar.arrive_and_wait();
  return r;
}
}  // namespace emu

inline void __syncthreads() { emu::blk->bar->arrive_and_wait(); }
inline void __syncwarp(unsigned = 0xffffffffu) {
  emu::warp().bar.arrive_and_wait();
}
struct int2 { int x, y; };
inline int2 make_int2(int x, int y) { return {x, y}; }
template <class T> T __shfl_up_sync(unsigned, T v, unsigned d) {
  const int l = emu::lane();
  return emu::exchange(v, l >= (int)d ? l - (int)d : l);
}
template <class T> T __shfl_down_sync(unsigned, T v, unsigned d) {
  const int l = emu::lane();
  return emu::exchange(v, l + (int)d < 32 ? l + (int)d : l);
}
template <class T> T __shfl_sync(unsigned, T v, int src) {
  return emu::exchange(v, src & 31);
}
namespace emu {
// every lane's value folded with f over the warp, given to every lane
template <class T, class F> T all_reduce(T v, F f) {
  Warp& w = warp();
  uint64_t bits = 0;
  std::memcpy(&bits, &v, sizeof(T));
  w.slot[lane()] = bits;
  w.bar.arrive_and_wait();
  T r;
  std::memcpy(&r, &w.slot[0], sizeof(T));
  for (int i = 1; i < 32; ++i) {
    T o;
    std::memcpy(&o, &w.slot[i], sizeof(T));
    r = f(r, o);
  }
  w.bar.arrive_and_wait();
  return r;
}
}  // namespace emu
inline int __reduce_max_sync(unsigned, int v) {
  return emu::all_reduce(v, [](int a, int b) { return a > b ? a : b; });
}
inline unsigned __reduce_min_sync(unsigned, unsigned v) {
  return emu::all_reduce(v, [](unsigned a, unsigned b) { return a < b ? a : b; });
}
inline unsigned __ballot_sync(unsigned, bool p) {
  emu::Warp& w = emu::warp();
  w.slot[emu::lane()] = p;
  w.bar.arrive_and_wait();
  unsigned m = 0;
  for (int i = 0; i < 32; ++i) if (w.slot[i]) m |= 1u << i;
  w.bar.arrive_and_wait();
  return m;
}
inline int __ffs(unsigned x) { return __builtin_ffs((int)x); }
inline int min(int a, int b) { return a < b ? a : b; }
inline int max(int a, int b) { return a > b ? a : b; }
struct uint4 { unsigned x, y, z, w; };
struct int4 { int x, y, z, w; };
inline uint4 make_uint4(unsigned x, unsigned y, unsigned z, unsigned w) {
  return {x, y, z, w};
}
inline unsigned __funnelshift_r(unsigned lo, unsigned hi, unsigned s) {
  return (unsigned)((((uint64_t)hi << 32) | lo) >> (s & 31));
}
// the int16x2 SIMD intrinsics: each halfword on its own, wrapping
template <class F> unsigned emu_halves(unsigned a, unsigned b, F f) {
  unsigned r = 0;
  for (int h = 0; h < 2; ++h) {
    const int16_t x = (int16_t)(a >> (16 * h)), y = (int16_t)(b >> (16 * h));
    r |= ((unsigned)(uint16_t)f(x, y)) << (16 * h);
  }
  return r;
}
inline unsigned __vadd2(unsigned a, unsigned b) {
  return emu_halves(a, b, [](int x, int y) { return x + y; });
}
inline unsigned __vsub2(unsigned a, unsigned b) {
  return emu_halves(a, b, [](int x, int y) { return x - y; });
}
inline unsigned __vmaxs2(unsigned a, unsigned b) {
  return emu_halves(a, b, [](int x, int y) { return x > y ? x : y; });
}
inline unsigned __viaddmax_s16x2(unsigned a, unsigned b, unsigned c) {
  return __vmaxs2(__vadd2(a, b), c);
}
inline int __viaddmax_s32(int a, int b, int c) {
  const int s = (int)((unsigned)a + (unsigned)b);
  return s > c ? s : c;
}
inline float __int2float_rn(int v) { return (float)v; }
// a 16-byte vector access needs a 16-byte aligned address on a card
// (x86 forgives it): every cast to a vector pointer is counted if not
inline std::atomic<int> emu_misaligned{0};
extern "C" int emu_misaligned_vectors() { return emu_misaligned.load(); }
namespace emu {
template <class P, class Q> P vector_cast(Q q) {
  if (reinterpret_cast<uintptr_t>(q) % 16) ++emu_misaligned;
  return reinterpret_cast<P>(q);
}
}  // namespace emu
inline int atomicMax(int* p, int v) {
  std::atomic_ref<int> r(*p);
  int old = r.load();
  while (old < v && !r.compare_exchange_weak(old, v)) {}
  return old;
}
"""


def _translate(src: str) -> str:
    """A kernel source as C++ for the emulation: the header in place of
    cuda_runtime.h, dynamic shared memory from the block's buffer, casts
    to 16-byte vector pointers checked for alignment, and every
    <<<grid, block, smem, stream>>> launch as a call."""
    src = src.replace("#include <cuda_runtime.h>", '#include "emulation.h"')
    src = re.sub(r"reinterpret_cast<((?:const )?u?int4\*)>\(",
                 r"emu::vector_cast<\1>(", src)
    src = re.sub(r"extern __shared__ (\w[\w ]*?) (\w+)\[\];",
                 r"\1* \2 = reinterpret_cast<\1*>(emu::dyn_smem());", src)
    return re.sub(r"([\w:]+(?:<[^;()]*?>)?)\s*<<<([^>]*)>>>\(",
                  r"emu::launch(\2, &\1, ", src)


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """The plain versions run thousands of small tensor steps; one
    intra-op thread runs them about as fast as a pool and leaves the
    host's cores to the emulated kernels' threads and the other test
    workers."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def emulated(tmp_path_factory):
    """name -> build of csrc/<name>.cu for the emulation."""
    if shutil.which("g++") is None:
        pytest.skip("needs g++ to build the emulated kernels")
    d = tmp_path_factory.mktemp("emulated_kernels")
    (d / "emulation.h").write_text(EMULATION)
    built = {}

    def build(name, copy=""):
        key = name + copy
        if key not in built:
            cpp = d / f"{name}.cpp"
            if not cpp.exists():
                cpp.write_text(_translate(
                    (cuda_build.CSRC / f"{name}.cu").read_text()))
                subprocess.run(["g++", "-std=c++20", "-O1", "-shared",
                                "-fPIC", "-pthread", "-w", f"-I{d}", "-o",
                                str(d / f"lib{name}.so"), str(cpp)],
                               check=True)
            # a copy loads as a library of its own, with its own statics
            so = d / f"lib{key}.so"
            if copy:
                shutil.copy(d / f"lib{name}.so", so)
            built[key] = ctypes.CDLL(str(so))
        return built[key]
    return build


def _emulated_sort(lib, ops, nk):
    """psort.bitonic_sort's launch, on CPU buffers."""
    shape = ops[0].shape
    N = shape[-1]
    B = int(np.prod(shape[:-1], dtype=np.int64))
    outs = [torch.full((B, N), -7, dtype=torch.int64) for _ in ops]
    ins = [o.reshape(B, N) for o in ops]
    wk = torch.full((2, nk, B, N), -9, dtype=torch.int64)
    widx = torch.full((2, B, N), -9, dtype=torch.int32)
    desc = (ctypes.c_int64 * (4 * len(ops)))(
        *[x.data_ptr() for x in ins], *[o.data_ptr() for o in outs],
        *[x.stride(0) for x in ins], *[x.stride(1) for x in ins])
    fn = cuda_build.bind(lib, "psort_launch", psort.ARGS)
    assert fn(ctypes.addressof(desc), nk, len(ops), B, N, wk.data_ptr(),
              widx.data_ptr(), None) == 0
    return [o.reshape(shape) for o in outs]


# (case, SMs): 132 SMs takes the narrow tiles for these few rows (and
# the wide ones for wide_tile*), one SM the wide tiles everywhere
SORT_RUNS = [("k1p2", 132), ("k2p1", 132), ("k3p2", 1), ("k4p1", 132),
             ("n0", 132), ("n1", 132), ("n127", 1), ("n4097", 1),
             ("n4097", 132), ("n1_1d", 132), ("all_full", 1),
             ("all_ties", 132), ("negative", 1), ("narrow_tile_m1", 132),
             ("narrow_tile_p1", 132), ("narrow_tile3_p1", 132),
             ("wide_tile_p1", 132)]


@pytest.mark.parametrize("case,sms", SORT_RUNS)
def test_emulated_sort_kernel_matches_plain(emulated, case, sms):
    lib = emulated("sort", f"_sms{sms}")
    lib.emu_set_sms(sms)
    planes, nk = sort_case(case, seed=len(case))
    ops = [torch.from_numpy(p) for p in planes]
    for g, w in zip(_emulated_sort(lib, ops, nk),
                    psort.bitonic_sort_plain(ops, nk)):
        assert torch.equal(g, w)


def test_emulated_sort_kernel_takes_strided_planes_and_wide_keys(emulated):
    lib = emulated("sort", "_sms1")
    lib.emu_set_sms(1)
    rng = np.random.default_rng(8)
    both = torch.from_numpy(rng.integers(-(1 << 40), 1 << 40, (3, 2500, 3)))
    ops = [both[..., 1], both[..., 0] % 5, both[..., 2]]
    for g, w in zip(_emulated_sort(lib, ops, 2),
                    psort.bitonic_sort_plain(ops, 2)):
        assert torch.equal(g, w)


def _emulated_sw(lib, q, ql, t, tl, params, mode, slack):
    """sw_cuda.sw_batch_cuda's launch, on CPU buffers (the strips'
    scratch rows filled with garbage first)."""
    B, Lq = q.shape
    Lt = t.shape[1]
    out = [torch.full((B,), -5, dtype=torch.int32) for _ in range(3)]
    scratch = (torch.full((B, Lq + Lt, 2), -77, dtype=torch.int32)
               if Lq > sw_cuda.STRIP_ROWS else None)
    fn = cuda_build.bind(lib, "sw_batch_launch", sw_cuda.ARGS)
    assert fn(q.data_ptr(), ql.data_ptr(), t.data_ptr(), tl.data_ptr(), B,
              Lq, Lt, params.match, params.mismatch,
              params.gap_open, params.gap_extend, sw_cuda.MODES[mode], slack,
              *[o.data_ptr() for o in out],
              None if scratch is None else scratch.data_ptr(), None) == 0
    return out


def _check_sw(lib, pairs, params, mode, slack):
    args = [torch.from_numpy(np.ascontiguousarray(x)) for x in pairs]
    got = _emulated_sw(lib, *args, params, mode, slack)
    want = sw_cuda.sw_batch_plain(*args, params, mode, slack)
    for g, w in zip(got, want):
        assert torch.equal(g, w)


@pytest.mark.parametrize("mode", ["local", "overlap", "fit", "extend"])
@pytest.mark.parametrize("params", [BWA_PARAMS, SWParams(1, -1, 1, 1)],
                         ids=["bwa", "unit"])
def test_emulated_sw_kernel_matches_plain(emulated, mode, params):
    """Ragged pairs with forced ties (poly-A, one repeated base) at
    bands of 2 and 10 rows a lane."""
    lib = emulated("sw")
    slack = 3 if mode == "overlap" else 0
    for i, (B, Lq, Lt) in enumerate(((40, 24, 48), (9, 300, 90))):
        _check_sw(lib, sw_test_pairs(i, B, Lq, Lt), params, mode, slack)


@pytest.mark.parametrize("shape", [s for s in SW_EDGE_SHAPES if s[1] <= 320],
                         ids=lambda s: f"{s[0]}x{s[1]}x{s[2]}")
def test_emulated_sw_kernel_at_band_edges(emulated, shape):
    """The card's edge shapes, all four modes, and rows beyond the
    callers' contract: targets longer than their row (cells past
    i + j = Lq + Lt are no candidates), queries longer than Lq, and
    negative codes."""
    lib = emulated("sw")
    B, Lq, Lt = shape
    q, ql, t, tl = sw_edge_pairs(100 + Lq, B, Lq, Lt)
    tl[16:20] = Lt + np.array([1, 7, Lq, Lq + 40])
    ql[20:22] = Lq + 3
    q[22, ::3] = -1
    t[22, ::2] = -1
    for mode in ("local", "overlap", "fit", "extend"):
        _check_sw(lib, (q, ql, t, tl), SWParams(2, -3, 5, 2), mode,
                  2 if mode == "overlap" else 0)


@pytest.mark.parametrize("mode", ["local", "overlap", "fit", "extend"])
@pytest.mark.parametrize("shape", SW_STRIP_SHAPES,
                         ids=lambda s: f"{s[0]}x{s[1]}x{s[2]}")
def test_emulated_sw_kernel_in_strips(emulated, shape, mode):
    """Queries of two and three strips of 1024 rows: ties whose best
    cells lie on either side of the strip edge, two-letter pairs, poly-A
    queries of 1023-1025 rows (fit mode's candidate row at the edge),
    targets longer than their row and, in overlap mode, an end slack of
    1100 rows and columns that spans every strip."""
    lib = emulated("sw")
    B, Lq, Lt = shape
    q, ql, t, tl = sw_strip_pairs(Lq + Lt, B, Lq, Lt)
    tl[8:10] = Lt + np.array([5, Lq])
    params = BWA_PARAMS if Lq % 2 else SWParams(2, -3, 5, 2)
    for slack in ((2, 1100) if mode == "overlap" else (0,)):
        _check_sw(lib, (q, ql, t, tl), params, mode, slack)


def _emulated_evaluate(lib, pairs, max_clip, match=1, mismatch=-2,
                       ind=-2):
    """evaluate_dp.eval_pack_cuda's launch, on CPU buffers (the strips'
    scratch filled with garbage first), scattered back to the pairs'
    order."""
    pack = evaluate_dp.pack_pairs(pairs)
    P = len(pack.order)
    buf = torch.from_numpy(pack.buffer())
    out = torch.full((P, 6), -5, dtype=torch.int32)
    scratch = torch.full((max(pack.scratch_len, 1),), -77, dtype=torch.int32)
    fn = cuda_build.bind(lib, "evaluate_launch", evaluate_dp.ARGS)
    assert fn(buf.data_ptr(), P, max_clip, match, mismatch, ind,
              out.data_ptr(), scratch.data_ptr(), None) == 0
    res = np.zeros((P, 6), np.int32)
    res[pack.order] = out.numpy()
    return res


@pytest.mark.parametrize("max_clip", [0, 2, 7, 50])
def test_emulated_evaluate_kernel_matches_plain(emulated, max_clip):
    """Ragged pairs out of length order: overlaps, containments, N runs,
    lengths 0 and 1, all-N, poly-A and two-letter ties, tiny pairs of
    two and three letters, pairs shorter than the clip (lines of index
    below 0), at bands of 2 to 12 rows a lane, under three scorings
    (ties between the moves differ in each)."""
    lib = emulated("evaluate")
    pairs = evaluate_test_pairs(200 + max_clip, count=24, lmax=330)
    for sc in ((1, -2, -2), (1, -1, -1), (2, -1, -1)):
        want = evaluate_dp.eval_pairs_device(pairs, max_clip, *sc,
                                             device="cpu")
        np.testing.assert_array_equal(
            _emulated_evaluate(lib, pairs, max_clip, *sc), want)


def test_emulated_evaluate_kernel_in_strips(emulated):
    """Queries of 1024, 1025 and 2049 rows (one, two and three strips):
    overlaps ending on the last row and two-letter ties, with candidate
    rows on both sides of a strip edge, and other scores (5, -3, -4)."""
    lib = emulated("evaluate")
    pairs = evaluate_test_pairs(7, count=2, long_rows=EVAL_STRIP_ROWS,
                                long_cols=40)
    for clip, sc in ((50, (1, -2, -2)), (3, (5, -3, -4))):
        want = evaluate_dp.eval_pairs_device(pairs, clip, *sc, device="cpu")
        np.testing.assert_array_equal(
            _emulated_evaluate(lib, pairs, clip, *sc), want)


def _emulated_traceback(lib, q, t, qend, tend, params, mode):
    """traceback_dp.stats_pack_cuda's launch, on CPU buffers (the strips'
    scratch filled with garbage first), scattered back to the winners'
    order."""
    pack = traceback_dp.pack_winners(q, t, qend, tend)
    P = len(pack.order)
    buf = torch.from_numpy(pack.buffer())
    out = torch.full((3, P), -5, dtype=torch.int32)
    scratch = torch.full((max(pack.scratch_len, 1),), -77, dtype=torch.int32)
    fn = cuda_build.bind(lib, "traceback_launch", traceback_dp.ARGS)
    assert fn(buf.data_ptr(), P, traceback_dp.MODES[mode], params.match,
              params.mismatch, params.gap_open, params.gap_extend,
              out.data_ptr(), scratch.data_ptr(), None) == 0
    res = np.zeros((3, P), np.int64)
    res[:, pack.order] = out.numpy()
    return res


@pytest.mark.parametrize("rows", ["bands", "strips"])
@pytest.mark.parametrize("mode", ["local", "fit"])
@pytest.mark.parametrize("params", [BWA_PARAMS, SWParams(1, -1, 1, 1)],
                         ids=["bwa", "unit"])
def test_emulated_traceback_kernel_matches_host(emulated, rows, mode,
                                                params):
    """Every winner's (qstart, tstart, m_sum) equal to the host
    traceback's: queries at the kernel's band edges (1-512 rows) or
    past its strips of 512 rows (513, 1100), targets with N-masked
    spans, ends at the best cell and at random cells, poly-A and tandem
    repeats that tie the diagonal against E or F, tiny two- and
    three-letter pairs, fit paths that start down column 0, ends on row
    or column 0; under bwa's scores and under unit scores (gap open
    equal to extension, so opening ties extending)."""
    lib = emulated("traceback")
    kw = (dict(cols=(24, 56), tiny=60, mid=24, dels=24) if rows == "bands" else
          dict(rows=TRACEBACK_STRIP_ROWS, cols=(24, 40), tiny=10,
                   mid=10, dels=10))
    q, ql, t, tl, qend, tend = traceback_winners(
        len(mode) + params.gap_open, mode, **kw)
    want = sw_host.alignment_stats_batch(q, ql, t, tl, params, mode, qend,
                                         tend)
    np.testing.assert_array_equal(
        _emulated_traceback(lib, q, t, qend, tend, params, mode),
        np.stack(want))


def _probe_entry(lib, name, *args, device=0):
    """csrc/probes.cu's `probe_<name>` with the argument types the
    wrapper binds it with (`probes._ARGS`), on CPU buffers, on emulated
    device `device`."""
    fn = cuda_build.bind(lib, f"probe_{name}", probes._ARGS[name])
    assert fn(*args, device, None) == 0
    assert lib.emu_misaligned_vectors() == 0


def _at(values: torch.Tensor, offset: int) -> torch.Tensor:
    """`values` copied into a buffer `offset` elements into its storage
    (a start off the 16-byte vector), the bytes around it garbage."""
    buf = torch.full((values.numel() + offset + 16,), -21555,
                     dtype=values.dtype)
    view = buf[offset:offset + values.numel()].view(values.shape)
    view.copy_(values)
    return view


# (R, W, rows j): widths a multiple of the vector and not, so that row j
# starts at every offset off the 16-byte vector; negative and
# out-of-range rows clamp as the JAX kernel's slice does
SUBLANE_RUNS = [((64, 128), (17, 0, 63, 64, 70, -1, -5, -70)),
                ((9, 37), (0, 1, 2, 3, 8, -2)), ((5, 1), (0, 3, 9, -1)),
                ((6, 2051), (1, 2, 3, 5)), ((3, 6), (0, 1, 2))]


@pytest.mark.parametrize("sms", [1, 132])
@pytest.mark.parametrize("shape,rows", SUBLANE_RUNS,
                         ids=lambda v: "x".join(map(str, v)))
def test_emulated_dynamic_sublane_matches_plain(emulated, shape, rows, sms):
    """The row read through the 16-byte streaming map: rows at every
    alignment, widths with scalar heads and tails, an output that starts
    off the vector too."""
    lib = emulated("probes", f"_sms{sms}")
    lib.emu_set_sms(sms)
    t = torch.from_numpy(probe_input("beyond_int16", shape, 3))
    R, W = shape
    for j in rows:
        idx = torch.tensor([[j]], dtype=torch.int32)
        want = ke.exp_dynamic_sublane_plain(t, idx)
        for off in (0, 1, 3):
            out = _at(torch.full((1, W), -7, dtype=torch.int32), off)
            _probe_entry(lib, "dynamic_sublane", idx.data_ptr(),
                         t.data_ptr(), R, W, out.data_ptr())
            assert torch.equal(out, want), (j, off)


# (S, W): one row, more than 1024, widths off the 8-lane vector
INT16_SHAPES = [(32, 128), (1, 7), (1, 4097), (2, 3), (7, 33), (1025, 33),
                (300, 5), (3000, 41)]


@pytest.mark.parametrize("sms", [1, 132])
@pytest.mark.parametrize("shape", INT16_SHAPES,
                         ids=lambda s: f"{s[0]}x{s[1]}")
def test_emulated_int16_roll_and_elementwise_match_plain(emulated, shape,
                                                         sms):
    """roll(x, 1, axis 0) and wrapping max(x + 3, x - 2) on inputs that
    start at each of the 8 int16 offsets off the 16-byte vector: the
    funnel-shifted loads, the scalar heads and tails, the roll's two
    ranges."""
    lib = emulated("probes", f"_sms{sms}")
    lib.emu_set_sms(sms)
    x = torch.from_numpy(probe_input("int16_full", shape, sum(shape)))
    S, W = shape
    for off in range(8):
        xv = _at(x, off)
        out = torch.full(shape, 77, dtype=torch.int16)
        _probe_entry(lib, "int16_roll", xv.data_ptr(), S, W, out.data_ptr())
        assert torch.equal(out, int16_repro.roll_plain(x)), off
        out = torch.full(shape, 77, dtype=torch.int16)
        _probe_entry(lib, "int16_elementwise", xv.data_ptr(), x.numel(),
                     out.data_ptr())
        assert torch.equal(out, int16_repro.elementwise_plain(x)), off


@pytest.mark.parametrize("name", ["dynamic_sublane", "int16_roll",
                                  "int16_elementwise"])
def test_emulated_map_entries_return_the_sm_query_error(emulated, name):
    """Where the SM count cannot be read, the entry returns the query's
    cudaError and launches nothing."""
    lib = emulated("probes", "_smerr")
    lib.emu_set_sms(0)
    x = torch.from_numpy(probe_input("int16_full", (7, 33), 1))
    t = torch.from_numpy(probe_input("beyond_int16", (7, 33), 3))
    idx = torch.tensor([[2]], dtype=torch.int32)
    out = torch.full((7, 33), 77, dtype=x.dtype if "int16" in name
                     else torch.int32)
    args = {"dynamic_sublane": (idx.data_ptr(), t.data_ptr(), 7, 33),
            "int16_roll": (x.data_ptr(), 7, 33),
            "int16_elementwise": (x.data_ptr(), x.numel())}[name]
    fn = cuda_build.bind(lib, f"probe_{name}", probes._ARGS[name])
    try:
        assert fn(*args, out.data_ptr(), 0, None) == 1
    finally:
        lib.emu_set_sms(132)    # the emulation's state is shared by copies
    assert (out == 77).all()


def test_emulated_probe_entries_launch_on_the_given_device(emulated):
    """An entry makes the tensors' device current for its launch and
    gives the caller's back; on the current device it sets nothing."""
    lib = emulated("probes", "_device")
    x = torch.from_numpy(probe_input("int16_full", (7, 33), 1))
    out = torch.empty_like(x)
    _probe_entry(lib, "int16_roll", x.data_ptr(), 7, 33, out.data_ptr())
    assert lib.emu_set_device_calls() == 0
    _probe_entry(lib, "int16_roll", x.data_ptr(), 7, 33, out.data_ptr(),
                 device=1)
    assert lib.emu_get_device() == 0 and lib.emu_set_device_calls() == 2
    assert torch.equal(out, int16_repro.roll_plain(x))


# (S, W) of the loops: bands of R = 1..32 rows a lane, S = 32 R (no
# select) and not (a partial last band: 5, 100, 1000; lanes past the
# column's last row), one row, odd widths (the int16 loop's last column
# pair half dead), several blocks of warps
LOOP_SHAPES = [(128, 6), (32, 3), (1, 5), (5, 7), (64, 4), (33, 1),
               (100, 9), (1024, 2), (1000, 3), (256, 37)]
LOOP_STEPS = 40


def _emulated_loop(lib, x, steps, lanes=2, dpx=None):
    """exp_int16_loop's launch (dpx None) or recurrence_yardstick's, on
    CPU buffers; the output starts as garbage and the guard elements
    after it stay untouched (an odd width's dead half is not stored)."""
    S, W = x.shape
    buf = torch.full((S * W + 8,), -12345, dtype=torch.int32)
    out = buf[:S * W].view(S, W)
    if dpx is None:
        _probe_entry(lib, "int16_loop", x.data_ptr(), S, W, steps,
                     out.data_ptr())
    else:
        _probe_entry(lib, "loop_yardstick", x.data_ptr(), S, W, steps,
                     lanes, int(dpx), out.data_ptr())
    assert (buf[S * W:] == -12345).all()
    return out


@pytest.mark.parametrize("shape", LOOP_SHAPES, ids=lambda s: f"{s[0]}x{s[1]}")
def test_emulated_int16_loop_matches_plain(emulated, shape):
    """The warp-band int16x2 loop on every input where int16 wraps (h + 1,
    e - 1, the cast), at every band size, partial bands and odd widths."""
    lib = emulated("probes")
    for name in INT16_LOOP_INPUTS:
        x = torch.from_numpy(probe_input(name, shape, 1))
        got = _emulated_loop(lib, x, LOOP_STEPS)
        assert torch.equal(got, ke.exp_int16_loop_plain(x, LOOP_STEPS)), name


@pytest.mark.parametrize("shape", LOOP_SHAPES, ids=lambda s: f"{s[0]}x{s[1]}")
def test_emulated_loop_yardsticks_match_where_nothing_wraps(emulated, shape):
    """int32 lanes and the DPX forms of the loop equal it within
    +-16000."""
    lib = emulated("probes")
    x = torch.from_numpy(probe_input("beyond_int16", shape, 9) // 100)
    want = ke.exp_int16_loop_plain(x, LOOP_STEPS)
    for lanes, dpx in ((1, False), (1, True), (2, False), (2, True)):
        got = _emulated_loop(lib, x, LOOP_STEPS, lanes, dpx)
        assert torch.equal(got, want), (lanes, dpx)


@pytest.mark.parametrize("shape", LOOP_SHAPES, ids=lambda s: f"{s[0]}x{s[1]}")
def test_emulated_int32_argmax_matches_plain(emulated, shape):
    """The warp-band argmax loop: the two warp reductions a step, the
    first row under float32 ties, int32 wrapping, and rows past S kept
    out of the max."""
    lib = emulated("probes")
    S, W = shape
    for name in ARGMAX_INPUTS:
        x = torch.from_numpy(probe_input(name, shape, 2))
        out = torch.full_like(x, -12345)
        am = torch.full((W,), -6, dtype=torch.int32)
        _probe_entry(lib, "int32_argmax", x.data_ptr(), S, W, LOOP_STEPS,
                     out.data_ptr(), am.data_ptr())
        want_out, want_am = ke.exp_int32_loop_with_argmax_plain(
            x, LOOP_STEPS)
        assert torch.equal(out, want_out), name
        assert torch.equal(am, want_am), name


def test_emulated_argmax_loop_wraps_int32_and_picks_the_first_float_tie(
        emulated):
    """Rows near INT32_MAX wrap on h + 1 (the max moves to the wrapped
    column's other rows), and distinct ints that round to one float32
    take the first row."""
    lib = emulated("probes")
    S, W = 100, 3
    x = np.full((S, W), -5, np.int32)
    x[7:, 0] = np.iinfo(np.int32).max - 3
    x[[3, 60, 99], 1] = [(1 << 29) + 3, (1 << 29) + 1, (1 << 29) + 2]
    x[:, 2] = np.arange(S)[::-1]
    x = torch.from_numpy(x)
    out = torch.full_like(x, -1)
    am = torch.full((W,), -6, dtype=torch.int32)
    _probe_entry(lib, "int32_argmax", x.data_ptr(), S, W, 6, out.data_ptr(),
                 am.data_ptr())
    want_out, want_am = ke.exp_int32_loop_with_argmax_plain(x, 6)
    assert torch.equal(out, want_out) and torch.equal(am, want_am)


# swprobe's band edges (testcases.SWPROBE_SHAPES), each with a number of
# steps: nstep / 8 steps a grid step, so the fori index s restarts 8
# times and B's row mask moves with it
SWPROBE_STEPS = (16, 24, 32, 40, 48, 40, 48)


def _emulated_swprobe(lib, x, level, nstep):
    """swprobe.run's launch on CPU buffers: the output starts as garbage
    and the guard elements after it stay untouched."""
    S, W = x.shape
    buf = torch.full((W + 8,), -12345, dtype=torch.int32)
    _probe_entry(lib, "swprobe", x.data_ptr(), S, W, nstep,
                 nstep // swprobe.GRID_STEPS, level, buf.data_ptr())
    assert (buf[W:] == -12345).all()
    return buf[:W].view(1, W)


@pytest.mark.parametrize("S,W,nstep", [
    (S, W, n) for (S, W), n in zip(SWPROBE_SHAPES, SWPROBE_STEPS)],
    ids=lambda v: str(v))
def test_emulated_swprobe_matches_plain(emulated, S, W, nstep):
    """The warp-band ladder at every level: row 0's selects on lane 0,
    the shuffled C, D and E at band edges, tr's rotating read across the
    wrap from row S - 1 to row 0, dead rows kept out of the column max,
    C's clamp at 0 on negative inputs, B's row mask (rows 1..s, which
    decide the max of the narrow shapes' columns) and int32 wrapping
    near INT32_MAX."""
    lib = emulated("probes")
    for name in ("beyond_int16", *SWPROBE_INPUTS):
        x = torch.from_numpy(probe_input(name, (S, W), S + W))
        for level in swprobe.LEVELS:
            got = _emulated_swprobe(lib, x, level, nstep)
            assert torch.equal(got, swprobe.run_plain(x, level, nstep)), (
                name, level)


def test_emulated_swprobe_refuses_what_it_does_not_take(emulated):
    """More than 1024 rows, a level outside 0-3 or steps with no grid
    step return cudaErrorInvalidValue and write nothing."""
    lib = emulated("probes")
    fn = cuda_build.bind(lib, "probe_swprobe", probes._ARGS["swprobe"])
    x = torch.zeros((1025, 4), dtype=torch.int32)
    out = torch.full((4,), 77, dtype=torch.int32)
    for S, nstep, chunk, level in ((1025, 8, 1, 3), (8, 8, 1, 4),
                                   (8, 8, 1, -1), (8, 8, 0, 3)):
        assert fn(x.data_ptr(), S, 4, nstep, chunk, level, out.data_ptr(),
                  0, None) == 1
    assert (out == 77).all()
