"""The int16 lowering probes, on the card.

Counterpart of scripts/mosaic_int16_repro.py, whose two Pallas kernels
showed that int16 did not lower on the TPU toolchain: `elementwise`
(int16 max(x + 3, x - 2), wrapping) and `roll` (roll(x, 1, axis 0): row
r takes row r - 1, row 0 the last row). Here both are kernels of
`csrc/probes.cu` (16-byte vectors of 8 int16 a thread, whatever the
input's alignment; the roll as two contiguous ranges, out[1:] = x[:-1]
and out[0] = x[-1], so any number of rows), each with its plain twin.

    python -m gappadder_tpu_torch.probes.int16_repro
"""

from __future__ import annotations

import numpy as np
import torch

from . import inputs, launch

SHAPE = (32, 128)                       # the script's shape


def script_input() -> np.ndarray:
    """The script's input: arange(32 * 128) as int16 [32, 128]."""
    return np.arange(SHAPE[0] * SHAPE[1], dtype=np.int16).reshape(SHAPE)


def elementwise_plain(x: torch.Tensor):
    return torch.maximum(x + 3, x - 2)


def roll_plain(x: torch.Tensor):
    return torch.roll(x, 1, 0)


def elementwise(x=None, device="cuda"):
    """int16 max(x + 3, x - 2) of x int16 (default the script's arange
    [32, 128]), any shape; on the card the input may start at any
    element of its storage."""
    index, (x,) = inputs("int16_repro.elementwise", device, torch.int16,
                         script_input() if x is None else x)
    if index is None:
        return elementwise_plain(x)
    out = torch.empty_like(x)
    launch("int16_elementwise", index, x.data_ptr(), x.numel(),
           out.data_ptr())
    return out


def roll(x=None, device="cuda"):
    """roll(x, 1, axis 0) of x int16 [S, W] (default the script's
    arange [32, 128]), any number of rows and any width."""
    index, (x,) = inputs("int16_repro.roll", device, torch.int16,
                         script_input() if x is None else x)
    if x.dim() != 2:
        raise ValueError(f"int16_repro.roll: expected [S, W], got "
                         f"{tuple(x.shape)}")
    if index is None:
        return roll_plain(x)
    out = torch.empty_like(x)
    launch("int16_roll", index, x.data_ptr(), x.shape[0], x.shape[1],
           out.data_ptr())
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
