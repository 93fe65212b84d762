"""The int16 lowering probes, on the card.

Counterpart of scripts/mosaic_int16_repro.py, whose two Pallas kernels
showed that int16 did not lower on the TPU toolchain: `elementwise`
(int16 max(x + 3, x - 2), wrapping) and `roll` (roll(x, 1, axis 0): row
r takes row r - 1, row 0 the last row). Here both are kernels of
`csrc/probes.cu` (two int16 lanes a thread for the elementwise one; the
roll through shared memory, as the SW-shaped loops exchange a step),
each with its plain twin.

    python -m gappadder_tpu_torch.probes.int16_repro
"""

from __future__ import annotations

import numpy as np
import torch

from .. import entry_device
from . import check_rows, launch, tensor_on

SHAPE = (32, 128)                       # the script's shape


def script_input() -> np.ndarray:
    """The script's input: arange(32 * 128) as int16 [32, 128]."""
    return np.arange(SHAPE[0] * SHAPE[1], dtype=np.int16).reshape(SHAPE)


def elementwise_plain(x: torch.Tensor):
    return torch.maximum(x + 3, x - 2)


def roll_plain(x: torch.Tensor):
    return torch.roll(x, 1, 0)


def elementwise(x=None, device="cuda"):
    """int16 max(x + 3, x - 2) of x int16 [S, W] (default the script's
    arange [32, 128]), any shape on the card."""
    dev = entry_device(device, "int16_repro.elementwise")
    x = tensor_on(script_input() if x is None else x, torch.int16, dev,
                  "int16_repro.elementwise")
    if dev.type == "cpu":
        return elementwise_plain(x)
    if x.data_ptr() % 4:                # two int16 lanes a 32-bit word
        x = x.clone()
    if x.numel() >= 1 << 31:
        raise ValueError("int16_repro.elementwise: too many elements")
    out = torch.empty_like(x)
    launch("int16_elementwise", dev, x, x.numel(), out)
    return out


def roll(x=None, device="cuda"):
    """roll(x, 1, axis 0) of x int16 [S, W] (default the script's
    arange [32, 128]); at most 1024 rows on the card."""
    dev = entry_device(device, "int16_repro.roll")
    x = tensor_on(script_input() if x is None else x, torch.int16, dev,
                  "int16_repro.roll")
    check_rows("int16_repro.roll", x)
    if dev.type == "cpu":
        return roll_plain(x)
    out = torch.empty_like(x)
    launch("int16_roll", dev, x, x.shape[0], x.shape[1], out)
    return out


def main() -> dict:
    """Run both kernels on the card on the script's input, as the script
    does, and hold each to its plain twin: prints OK and the first four
    values of row 0, and raises on a wrong result."""
    x = torch.from_numpy(script_input()).cuda()
    res = {}
    for name, fn, plain in (("int16 elementwise (add/sub/max)", elementwise,
                             elementwise_plain),
                            ("int16 roll", roll, roll_plain)):
        out = fn(x)
        ok = torch.equal(out, plain(x))
        print(f"{name}: {'OK' if ok else 'WRONG'} "
              f"{out[0, :4].cpu().numpy()}", flush=True)
        if not ok:
            raise AssertionError(f"{name}: kernel != plain")
        res[fn.__name__] = out
    return res


if __name__ == "__main__":
    main()
