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

import torch

from .. import entry_device
from ..ops import cuda_build

# kernel launches since the last reset, by csrc/probes.cu entry
# (probe_<name>); chip_smoke.py reads them
launches = dict.fromkeys(("dynamic_sublane", "int16_loop", "loop_yardstick",
                          "int32_argmax", "swprobe", "int16_elementwise",
                          "int16_roll"), 0)

# the loops' most rows: the int16, argmax and swprobe loops hold a
# column in one warp, 32 lanes of at most 32 rows (swprobe 33)
MAX_ROWS = 1024

# each C entry's arguments before the stream (cuda_build.CTYPES codes),
# the last the device index
_ARGS = {"dynamic_sublane": "ppiipi", "int16_loop": "piiipi",
         "loop_yardstick": "piiiiipi", "int32_argmax": "piiippi",
         "swprobe": "piiiiipi", "int16_elementwise": "pqpi",
         "int16_roll": "piipi"}

_devices: dict = {}     # a device string -> its torch.device


def tensor_on(a, dtype: torch.dtype, device: torch.device,
              entry: str) -> torch.Tensor:
    """`a` (numpy or tensor) as a contiguous tensor on `device`; its
    dtype must already be `dtype`."""
    t = torch.as_tensor(a)
    if t.dtype != dtype:
        raise TypeError(f"{entry}: expected {dtype}, got {t.dtype}")
    return t.to(device).contiguous()


def inputs(entry: str, device, dtype: torch.dtype, *arrays):
    """(index, tensors): the card a probe wrapper runs on (None on the
    CPU) and `arrays` (numpy or tensors) as contiguous `dtype` tensors
    there. Tensors that already are such, all on one card that `device`
    names (any card for "cuda" with no index), go through untouched,
    read by their attributes alone, and the kernel runs on their card,
    whichever device is current; anything else is checked and converted
    (`entry_device`, `tensor_on`), onto the current card for "cuda".
    Raises TypeError on another dtype."""
    index = None
    for a in arrays:
        if not (type(a) is torch.Tensor and a.is_cuda and a.dtype == dtype
                and a.is_contiguous()):
            break
        i = a.get_device()
        if index is None:
            dev = device if type(device) is torch.device else \
                _devices.get(device) or _devices.setdefault(
                    device, torch.device(device))
            if dev.type != "cuda" or dev.index not in (None, i):
                break
        elif i != index:
            break
        index = i
    else:
        return index, arrays
    dev = entry_device(device, entry)
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    return dev.index, [tensor_on(a, dtype, dev, entry) for a in arrays]


def check_rows(entry: str, x: torch.Tensor) -> None:
    """x is [S, W] with 1 <= S <= MAX_ROWS: the loop kernels hold a
    column's rows in one warp."""
    if x.dim() != 2:
        raise ValueError(f"{entry}: expected [S, W], got {tuple(x.shape)}")
    S = x.shape[0]
    if not 1 <= S <= MAX_ROWS:
        raise ValueError(f"{entry}: {S} rows; the kernel takes 1.."
                         f"{MAX_ROWS} rows")


def kernel(name: str):
    """csrc/probes.cu's `probe_<name>`, bound (built and loaded at first
    use)."""
    return cuda_build.bind("probes", f"probe_{name}", _ARGS[name])


def launch(name: str, index: int, *args) -> None:
    """Launch csrc/probes.cu's `probe_<name>` on card `index` (the entry
    makes it current for the launch and gives the caller's device back)
    on PyTorch's current stream there. `args` are the entry's own, each
    a pointer (`data_ptr()`) or an int. Raises on a non-zero
    cudaError."""
    cuda_build.launch(kernel(name), index, *args, sets_device=True)
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

