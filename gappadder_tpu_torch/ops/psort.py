"""Batched lexicographic sort over 1-6 key planes plus payloads: the
CUDA kernel and its plain PyTorch version.

Counterpart of gappadder_tpu/ops/psort.py::bitonic_sort. On a CUDA
tensor `bitonic_sort` launches the hand-written kernel `csrc/sort.cu`,
the port of the Pallas bitonic network `_bitonic_call`, redesigned for
the H100 as a tiled merge sort: each block sorts a tile of 256-2048
elements of one row in registers and shared memory, then merge-path
passes merge the sorted runs pairwise over all rows at once, and the
last launch writes every output plane through the final index. Rows are
not padded; the input index is the last tie-break, so the result is the
stable sort's. What bounds it is bytes (every plane read and written
once); see the source for the design.

`bitonic_sort_plain` is an LSD chain of stable `torch.sort` passes over
the key planes, last key first: the counterpart of the JAX package's
default `lax.sort(is_stable=True)` branch. `bitonic_sort` runs it only
for tensors on the CPU. Both give the same result in every plane.

Keys and payloads are int64 tensors holding uint32 or int32 values
(k-mer limbs are stored as int64, see ops/kmers.py), so int32 keys
order as signed and uint32 keys as unsigned with no bit mapping; any
int64 key orders as signed int64.
"""

from __future__ import annotations

import ctypes

import torch

from . import cuda_build

MAX_KEYS = 6            # csrc/sort.cu: MAX_KEYS, MAX_PLANES
MAX_PLANES = 8
# psort_launch's arguments before the stream (cuda_build.CTYPES codes)
ARGS = "piiiipp"

# kernel launches since the last reset (chip_smoke.py reads this)
launches = 0


def _check(ops, num_keys: int) -> tuple:
    ops = tuple(ops)
    if not 1 <= num_keys <= len(ops):
        raise ValueError(f"bitonic_sort: num_keys={num_keys} with "
                         f"{len(ops)} planes")
    shape = ops[0].shape
    for o in ops:
        if o.dtype != torch.int64:
            raise TypeError(f"bitonic_sort: planes must be int64, got "
                            f"{o.dtype}")
        if o.shape != shape or o.dim() < 1:
            raise ValueError("bitonic_sort: planes must share one shape "
                             f"[..., N], got {[tuple(x.shape) for x in ops]}")
    return ops


def bitonic_sort_plain(ops, num_keys: int, stable: bool = False):
    """Sort a tuple of int64 [..., N] tensors ascending along the last
    axis, lexicographically by the first `num_keys` of them; the rest
    ride along. Returns a tuple in the same order.

    The LSD chain of stable passes is stable, so `stable=True` (equal
    keys keep their input order, like `lax.sort(is_stable=True)`) costs
    nothing extra; the flag is kept for the JAX signature."""
    del stable
    ops = _check(ops, num_keys)
    perm = None
    for l in range(num_keys - 1, -1, -1):
        key = ops[l] if perm is None else torch.gather(ops[l], -1, perm)
        _, idx = torch.sort(key, dim=-1, stable=True)
        perm = idx if perm is None else torch.gather(perm, -1, idx)
    return tuple(torch.gather(o, -1, perm) for o in ops)


def bitonic_sort(ops, num_keys: int, stable: bool = False):
    """Same contract as `bitonic_sort_plain`, always stable. CPU tensors
    take the plain version; CUDA tensors launch `csrc/sort.cu` (int64
    planes of one shape on one device, at most 6 keys and 8 planes) or
    raise."""
    global launches
    ops = _check(ops, num_keys)
    if all(o.device.type == "cpu" for o in ops):
        return bitonic_sort_plain(ops, num_keys, stable)
    dev = ops[0].device
    if dev.type != "cuda" or any(o.device != dev for o in ops):
        raise ValueError("bitonic_sort: all planes must be on one CUDA "
                         f"device, got {[str(o.device) for o in ops]}")
    if num_keys > MAX_KEYS or len(ops) > MAX_PLANES:
        raise ValueError(f"bitonic_sort: at most {MAX_KEYS} keys and "
                         f"{MAX_PLANES} planes, got {num_keys}/{len(ops)}")
    shape = ops[0].shape
    N = shape[-1]
    B = 1
    for s in shape[:-1]:
        B *= s
    if N >= 1 << 30 or B >= 1 << 31:
        raise ValueError(f"bitonic_sort: shape {tuple(shape)} too large")
    outs = [torch.empty((B, N), dtype=torch.int64, device=dev) for _ in ops]
    if B == 0 or N == 0:
        return tuple(o.reshape(shape) for o in outs)
    # a view where the leading axes collapse to one stride, else a copy
    ins = [o.reshape(B, N) for o in ops]
    # two ping-pong buffers of sorted runs: keys and the int32 index
    wk = torch.empty((2, num_keys, B, N), dtype=torch.int64, device=dev)
    widx = torch.empty((2, B, N), dtype=torch.int32, device=dev)
    desc = (ctypes.c_int64 * (4 * len(ops)))(
        *[x.data_ptr() for x in ins], *[o.data_ptr() for o in outs],
        *[x.stride(0) for x in ins], *[x.stride(1) for x in ins])

    cuda_build.launch(cuda_build.bind("sort", "psort_launch", ARGS),
                      dev.index, ctypes.addressof(desc), num_keys,
                      len(ops), B, N, wk.data_ptr(), widx.data_ptr())
    launches += 1
    return tuple(o.reshape(shape) for o in outs)
