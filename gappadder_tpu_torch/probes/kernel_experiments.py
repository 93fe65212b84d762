"""The three micro-experiments of the SW kernel's design, on the card.

Counterparts of scripts/tpu_kernel_experiments.py (its Pallas kernels
`exp_dynamic_sublane`, `exp_int16_loop`, `exp_int32_loop_with_argmax`),
as kernels of `csrc/probes.cu`, each with its plain twin:

- `exp_dynamic_sublane`: one row of t picked by an index that lives on
  the device;
- `exp_int16_loop`: `steps` steps of the SW-shaped int16 recurrence
  e = max(h - 1, e - 1), h = max(h of the row above + 1, e), h = max(h,
  -16384), wrapping as int16 does;
- `exp_int32_loop_with_argmax`: the same recurrence in int32 (without
  the floor) with a cross-row max and first argmax every step.

`recurrence_yardstick` times the int16 recurrence in other forms
(int32 lanes, DPX instructions) for the SW kernel's redesign.

    python -m gappadder_tpu_torch.probes.kernel_experiments
"""

from __future__ import annotations

import time

import numpy as np
import torch

from . import check_rows, cuda_ms, inputs, launch

S, TB, STEPS = 128, 128, 1024           # the script's shapes
SUBLANE_ROW = 17


def script_table() -> np.ndarray:
    """exp_dynamic_sublane's table: arange(64 * 128) as [64, 128]."""
    return np.arange(64 * 128, dtype=np.int32).reshape(64, 128)


# ---- exp_dynamic_sublane ---------------------------------------------------

def exp_dynamic_sublane_plain(t: torch.Tensor, idx: torch.Tensor):
    """out [1, W] = t[j] with j = idx[0, 0]; a negative j counts from the
    end and the row is then clamped into t, as the JAX kernel's dynamic
    ref slice does."""
    R = t.shape[0]
    j = idx.reshape(-1)[:1].long()
    j = torch.where(j < 0, j + R, j).clamp(0, R - 1)
    return t.index_select(0, j)


def exp_dynamic_sublane(t=None, idx=SUBLANE_ROW, device="cuda"):
    """t int32 [R, W] (default the script's [64, 128] arange), idx an int
    or int32 [1, 1] (default 17). Returns int32 [1, W] on `device`."""
    if isinstance(idx, int):
        idx = np.array([[idx]], np.int32)
    index, (t, idx) = inputs("exp_dynamic_sublane", device, torch.int32,
                             script_table() if t is None else t, idx)
    if t.dim() != 2 or idx.numel() != 1:
        raise ValueError("exp_dynamic_sublane: expected t [R, W], idx [1, 1]")
    if index is None:
        return exp_dynamic_sublane_plain(t, idx)
    out = t.new_empty((1, t.shape[1]))
    launch("dynamic_sublane", index, idx.data_ptr(), t.data_ptr(),
           t.shape[0], t.shape[1], out.data_ptr())
    return out


# ---- exp_int16_loop ----------------------------------------------------------

def exp_int16_loop_plain(x: torch.Tensor, steps: int = STEPS):
    """x int32 [S, W]; h = e = int16(x) (wrapping cast); `steps` steps of
    the recurrence in int16 (wrapping); returns int32(h)."""
    h = x.to(torch.int16)
    e = h
    for _ in range(steps):
        e = torch.maximum(h - 1, e - 1)
        h = torch.maximum(torch.roll(h, 1, 0) + 1, e)
        h = torch.clamp(h, min=-16384)
    return h.to(torch.int32)


def _loop_input(entry, x, device):
    index, (x,) = inputs(entry, device, torch.int32,
                         np.zeros((S, TB), np.int32) if x is None else x)
    check_rows(entry, x)
    return index, x


def exp_int16_loop(x=None, steps: int = STEPS, device="cuda"):
    """x int32 [S, W] (default the script's zeros [128, 128]); on the
    card a warp runs a pair of int16 columns. Returns int32 [S, W]."""
    index, x = _loop_input("exp_int16_loop", x, device)
    if index is None:
        return exp_int16_loop_plain(x, steps)
    out = torch.empty_like(x)
    launch("int16_loop", index, x.data_ptr(), x.shape[0], x.shape[1], steps,
           out.data_ptr())
    return out


def recurrence_yardstick(x: torch.Tensor, steps: int = STEPS,
                         lanes: int = 1, dpx: bool = False):
    """exp_int16_loop's recurrence in another form, for timing it:
    int32 lanes (lanes=1) or int16x2 (lanes=2), each max(a + b, c) as two
    instructions or one DPX instruction (dpx). Equals exp_int16_loop
    where nothing wraps: inputs within +-16000, at most 16000 steps.
    CUDA tensors only."""
    if x.device.type != "cuda" or x.dtype != torch.int32:
        raise ValueError("recurrence_yardstick: an int32 CUDA tensor")
    check_rows("recurrence_yardstick", x)
    if lanes not in (1, 2):
        raise ValueError(f"recurrence_yardstick: lanes={lanes}, not 1 or 2")
    x = x.contiguous()
    out = torch.empty_like(x)
    launch("loop_yardstick", x.get_device(), x.data_ptr(), x.shape[0],
           x.shape[1], steps, lanes, int(dpx), out.data_ptr())
    return out


# ---- exp_int32_loop_with_argmax ----------------------------------------------

def exp_int32_loop_with_argmax_plain(x: torch.Tensor, steps: int = STEPS):
    """x int32 [S, W], steps >= 1. Returns (h + bs) int32 [S, W] and the
    last step's first argmax over rows of float32(h), int32 [W]."""
    h = x
    e = x
    bs = torch.zeros_like(x[0:1])
    am = None
    for _ in range(steps):
        e = torch.maximum(h - 1, e - 1)
        h = torch.maximum(torch.roll(h, 1, 0) + 1, e)
        m = h.max(dim=0, keepdim=True).values
        am = torch.argmax(h.to(torch.float32), dim=0).to(torch.int32)
        bs = torch.maximum(bs, m)
    return h + bs, am


def exp_int32_loop_with_argmax(x=None, steps: int = STEPS, device="cuda"):
    """x int32 [S, W] (default the script's zeros [128, 128]); on the card
    a warp runs a column and reduces it each step. Returns (out int32
    [S, W], argmax int32 [W])."""
    index, x = _loop_input("exp_int32_loop_with_argmax", x, device)
    if steps < 1:
        raise ValueError("exp_int32_loop_with_argmax: steps >= 1")
    if index is None:
        return exp_int32_loop_with_argmax_plain(x, steps)
    out = torch.empty_like(x)
    am = x.new_empty(x.shape[1])
    launch("int32_argmax", index, x.data_ptr(), x.shape[0], x.shape[1],
           steps, out.data_ptr(), am.data_ptr())
    return out, am


# ---- the script's run on the card ----------------------------------------------

def main() -> dict:
    """Run the three experiments on the card at the script's shapes, as
    the script does: check the dynamic row read against t[17], then time
    each loop over 50 launches (CUDA events). Raises on a wrong result."""
    res = {}
    t = script_table()
    out = exp_dynamic_sublane(t, SUBLANE_ROW)
    ok = np.array_equal(out.cpu().numpy()[0], t[SUBLANE_ROW])
    print("dynamic sublane slice:", "OK" if ok else "WRONG", flush=True)
    if not ok:
        raise AssertionError("exp_dynamic_sublane: wrong row")
    res["dynamic_sublane"] = out

    x = torch.zeros((S, TB), dtype=torch.int32, device="cuda")
    t0 = time.time()
    h = exp_int16_loop(x)
    torch.cuda.synchronize()
    print(f"int16 loop build+run: {time.time() - t0:.1f}s", flush=True)
    us = cuda_ms(lambda: exp_int16_loop(x), 50) * 1e3
    print(f"int16 5-op loop: {us:.0f} us for {STEPS} steps "
          f"({us / STEPS * 1e3:.0f} ns/step)", flush=True)
    res["int16_loop"] = h

    res["int32_argmax"] = exp_int32_loop_with_argmax(x)
    us = cuda_ms(lambda: exp_int32_loop_with_argmax(x), 50) * 1e3
    print(f"int32 4-op + argmax loop: {us:.0f} us "
          f"({us / STEPS * 1e3:.0f} ns/step)", flush=True)
    return res


if __name__ == "__main__":
    main()
