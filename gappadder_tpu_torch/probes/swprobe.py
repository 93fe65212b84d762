"""The SW-shaped wavefront ladder, on the card.

Counterpart of scripts/swprobe.py (`make_kernel` / `run`): per tile of
TB = 128 columns, S = 136 rows of five int32 state arrays A-E run
NSTEP = 1152 steps of the SW kernel's loop shape, in 8 grid steps of
144 whose loop index s restarts at 0 in each. The level sets what a
step does:

- 0: the loop alone (the rolled copy of x that feeds `tr`);
- 1: A's update from `tr`;
- 2: B, C and the exchange of C with the row above;
- 3: the full SW-like step (D and E exchanged as well).

The output is the per-column max over rows of A + B + C + D + E,
int32 [1, W]. The number of tiles follows from x's width W, so a wide x
fills the card. `run` launches `csrc/probes.cu`'s `swprobe_kernel`;
`run_plain` is the same function in tensor ops.

    python -m gappadder_tpu_torch.probes.swprobe [--verify]
"""

from __future__ import annotations

import sys

import numpy as np
import torch

from . import check_rows, cuda_ms, inputs, launch

S, TB, NBT, NSTEP = 136, 128, 4, 1152       # the script's shapes
GRID_STEPS = 8
LEVELS = (0, 1, 2, 3)


def script_input(seed: int = 0, tiles: int = NBT) -> np.ndarray:
    """The script's input: integers in [0, 100) from numpy's generator,
    [S, tiles * TB] int32."""
    rng = np.random.default_rng(seed)
    return rng.integers(0, 100, (S, tiles * TB)).astype(np.int32)


def run_plain(x: torch.Tensor, level: int, nstep: int = NSTEP):
    """x int32 [S, W]; returns int32 [1, W]."""
    n = x.shape[0]
    row = torch.arange(n, device=x.device)[:, None]
    rowm0 = row == 0
    A, B, C, D, E = (x + k for k in range(5))
    chunk = nstep // GRID_STEPS
    for g in range(nstep):
        s = g % chunk
        # the JAX kernel's buffer concat(x, x), rolled once a step from
        # the first step on: its rows S..2S-1 at step g
        tr = torch.roll(x, g + 1, 0)
        if level >= 1:
            A = torch.maximum(A - 1, tr)
            A = torch.where(rowm0, tr, A)
        if level >= 2:
            B = torch.maximum(B - 2, A - 7)
            C = torch.where(rowm0, A, torch.roll(C, 1, 0))
            C = torch.maximum(C, B)
            A = torch.where(C > A, C, A)
        if level >= 3:
            D = torch.maximum(torch.where(rowm0, A, torch.roll(D, 1, 0)),
                              C - 1)
            E = torch.where(D > E, D, E)
            sc = torch.where(tr == A, 1, -4).to(torch.int32)
            A = torch.maximum(A + sc, D)
            B = torch.where((row >= 1) & (row <= s), B, E)
            C = torch.clamp(C, min=0)
            E = torch.where(rowm0, C, torch.roll(E, 1, 0))
    return (A + B + C + D + E).max(dim=0, keepdim=True).values


def run(x=None, level: int = 3, nstep: int = NSTEP, device="cuda"):
    """x int32 [S, W] (default the script's [136, 512]); `nstep` a
    multiple of the 8 grid steps. Returns int32 [1, W] on `device`."""
    index, (x,) = inputs("swprobe.run", device, torch.int32,
                         script_input() if x is None else x)
    check_rows("swprobe.run", x)
    if level not in LEVELS or nstep % GRID_STEPS:
        raise ValueError(f"swprobe.run: level {level}, nstep {nstep}")
    if index is None:
        return run_plain(x, level, nstep)
    out = x.new_empty((1, x.shape[1]))
    launch("swprobe", index, x.data_ptr(), x.shape[0], x.shape[1], nstep,
           nstep // GRID_STEPS, level, out.data_ptr())
    return out


def main(verify: bool = False) -> dict:
    """Time each level on the card as the script does: 8 back-to-back
    runs (CUDA events), best of 3, in ms a run and ns per tile-step.
    With `verify`, also hold each level's output to `run_plain`."""
    x = torch.from_numpy(script_input()).cuda()
    res = {}
    for level in LEVELS:
        out = run(x, level)
        if verify:
            ok = torch.equal(out, run_plain(x, level))
            print(f"probe level{level} correct:", ok, flush=True)
            if not ok:
                raise AssertionError(f"swprobe level {level}: kernel != plain")
        best = min(cuda_ms(lambda: run(x, level), 8) for _ in range(3))
        print(f"level {level}: {best:.3f} ms "
              f"({best * 1e6 / NSTEP / NBT:.0f} ns/tile-step)", flush=True)
        res[level] = {"out": out, "ms": best}
    return res


if __name__ == "__main__":
    main(verify="--verify" in sys.argv)
