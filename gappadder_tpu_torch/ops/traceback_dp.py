"""Pick's tracebacks on the device: the (qstart, tstart, m_sum) of many
winning hits, one call a pass.

`alignment_stats_device` takes a pass's winners as `sw_host.
alignment_stats_batch` does (padded queries and targets, each winner's
end cell) and
  * on the card packs them ragged, longest first (`evaluate_dp.
    pack_pairs`: each winner's query up to its qend, its target up to its
    tend), and launches the hand-written kernel `csrc/traceback.cu` once
    for the whole pack: a warp a winner, a band of query rows a lane held
    in registers, the columns swept as an anti-diagonal wavefront that
    carries each cell's path origin and match count forward, queries
    past 512 rows in strips; no matrix in device memory. Its bound is
    int32 issue, about 33 operations a cell (see the source). It takes
    the `local` and `fit` modes and raises on others, and never falls
    back;
  * on the CPU is `sw_host.alignment_stats_batch`, the plain twin: the
    whole H, E and F fill and the walk, whose outputs are the kernel's
    contract.
"""

from __future__ import annotations

import numpy as np
import torch

from .. import entry_device
from . import cuda_build, evaluate_dp, sw_host
from .sw_host import SWParams

# kernel launches since the last reset (chip_smoke.py reads this)
launches = 0

STRIP_ROWS = 512    # csrc/traceback.cu sweeps longer queries in strips
EDGE_INTS = 8       # its scratch: a strip's last row, int32 a column
# traceback_launch's arguments before the stream (cuda_build.CTYPES codes)
ARGS = "piiiiiipp"
MODES = {"fit": 0, "local": 1}


def pack_winners(q, t, qend, tend) -> evaluate_dp.Pack:
    """The ragged pack of a pass's winners: winner b's query q[b, :qend[b]]
    and target t[b, :tend[b]], longest first, empty ones kept empty."""
    return evaluate_dp.pack_pairs(
        [(q[b, :int(qe)], t[b, :int(te)])
         for b, (qe, te) in enumerate(zip(qend, tend))],
        strip_rows=STRIP_ROWS, col_ints=EDGE_INTS, sentinels=False)


def launch(dbuf, P: int, out, scratch, p: SWParams, mode: str) -> None:
    """One launch of csrc/traceback.cu on the current stream: `dbuf` a
    pack's `buffer()` on the card, `out` int32 [3, P], `scratch` int32
    [scratch_len] (None where no winner takes strips)."""
    global launches
    if mode not in MODES:
        raise ValueError(f"traceback kernel: mode {mode!r} is not one of "
                         f"{sorted(MODES)}")
    cuda_build.launch(cuda_build.bind("traceback", "traceback_launch", ARGS),
                      dbuf.get_device(), dbuf.data_ptr(), P, MODES[mode],
                      p.match, p.mismatch, p.gap_open, p.gap_extend,
                      out.data_ptr(),
                      None if scratch is None else scratch.data_ptr())
    launches += 1


def stats_pack_cuda(pack: evaluate_dp.Pack, device, p: SWParams,
                    mode: str) -> np.ndarray:
    """Packed results int32 [3, P] (qstart, tstart, m_sum) by
    csrc/traceback.cu: one copy of the pack to the card, one launch, one
    readback."""
    # built and loaded before the pack reaches the card
    cuda_build.bind("traceback", "traceback_launch", ARGS)
    P = len(pack.order)
    dbuf = torch.from_numpy(pack.buffer()).to(device)
    out = torch.empty((3, P), dtype=torch.int32, device=device)
    scratch = (torch.empty(pack.scratch_len, dtype=torch.int32, device=device)
               if pack.scratch_len else None)
    launch(dbuf, P, out, scratch, p, mode)
    return out.cpu().numpy()


def alignment_stats_device(q, ql, t, tl, p: SWParams, mode: str, qend, tend,
                           device="cuda"):
    """(qstart, tstart, m_sum) int64 [B] of the paths `sw_host.traceback`
    walks back from each (qend[b], tend[b]) of q[b] against t[b], on
    `device` (the card unless the caller asks for "cpu"): on the card one
    launch of csrc/traceback.cu (or it raises), on the CPU
    `sw_host.alignment_stats_batch`."""
    device = entry_device(device, "alignment_stats_device")
    if device.type != "cuda":
        return sw_host.alignment_stats_batch(q, ql, t, tl, p, mode, qend,
                                             tend)
    B = len(qend)
    out = np.zeros((3, B), np.int64)
    if B:
        pack = pack_winners(np.asarray(q), np.asarray(t), qend, tend)
        out[:, pack.order] = stats_pack_cuda(pack, device, p, mode)
    return out[0], out[1], out[2]
