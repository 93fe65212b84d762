"""The probe kernels of the SW kernel's design, on the card.

The JAX package's `scripts/` holds five Pallas probes that the TPU
rounds used to shape the SW kernel: a dynamic row read, an int16 and an
int32 loop-carried recurrence with the SW kernel's shift to the row
above, the SW-shaped ladder from loop overhead to the full step, and
int16 elementwise and roll kernels. Each is ported here as a kernel of
`csrc/probes.cu` with a plain PyTorch twin:

- `kernel_experiments`: `exp_dynamic_sublane`, `exp_int16_loop`,
  `exp_int32_loop_with_argmax`;
- `swprobe`: `run(x, level)`;
- `int16_repro`: `elementwise`, `roll`.

Each entry point runs on the card unless given `device="cpu"`, where it
runs the plain twin, and raises without a card. Each module's `main()`
runs its probe on the card as its JAX script does:
`python -m gappadder_tpu_torch.probes.swprobe`.
"""

from __future__ import annotations

import ctypes

import torch

# kernel launches since the last reset, by csrc/probes.cu entry
# (probe_<name>); chip_smoke.py reads them
launches = dict.fromkeys(("dynamic_sublane", "int16_loop", "loop_yardstick",
                          "int32_argmax", "swprobe", "int16_elementwise",
                          "int16_roll"), 0)

MAX_THREADS = 1024      # a block holds every row of its columns

_fns: dict = {}         # probe_<name> with its argtypes set


def tensor_on(a, dtype: torch.dtype, device: torch.device,
              entry: str) -> torch.Tensor:
    """`a` (numpy or tensor) as a contiguous tensor on `device`; its
    dtype must already be `dtype`."""
    t = torch.as_tensor(a)
    if t.dtype != dtype:
        raise TypeError(f"{entry}: expected {dtype}, got {t.dtype}")
    return t.to(device).contiguous()


def check_rows(entry: str, x: torch.Tensor, multiple: int = 1) -> None:
    """The kernels keep a column's rows in one block."""
    if x.dim() != 2:
        raise ValueError(f"{entry}: expected [S, W], got {tuple(x.shape)}")
    S = x.shape[0]
    if not 1 <= S <= MAX_THREADS or S % multiple:
        raise ValueError(f"{entry}: {S} rows; the kernel takes 1.."
                         f"{MAX_THREADS} rows, a multiple of {multiple}")


def launch(name: str, dev: torch.device, *args) -> None:
    """Launch csrc/probes.cu's `probe_<name>` on the current stream of
    `dev`: tensors pass as pointers, Python ints as C ints. Raises on a
    non-zero cudaError."""
    fn = _fns.get(name)
    if fn is None:
        from ..ops import cuda_build
        fn = getattr(cuda_build.load("probes"), f"probe_{name}")
        fn.argtypes = [ctypes.c_void_p if torch.is_tensor(a) else
                       ctypes.c_int for a in args] + [ctypes.c_void_p]
        fn.restype = ctypes.c_int
        _fns[name] = fn
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = fn(*[a.data_ptr() if torch.is_tensor(a) else a for a in args],
                 stream)
    if err != 0:
        raise RuntimeError(f"probe_{name}: kernel launch failed "
                           f"(cudaError {err})")
    launches[name] += 1


def cuda_ms(fn, reps: int) -> float:
    """Mean milliseconds of fn() over `reps` back-to-back runs, by CUDA
    events."""
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps

