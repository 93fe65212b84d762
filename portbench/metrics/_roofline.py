"""The least time the H100 could take for the hand kernels' work, so
that a kernel's roofline share counts the same work whatever
implements it (shared by the `*_roofline.*` readers).

Sort: each key and payload plane of a call is read once and written
once, at its dtype's size, over the HBM bandwidth. A small call's
planes can sit in the 50 MB L2, so its share can read low for that
reason too.

SW: only live cells count (query length x target length over the
pairs whose query and target both hold more than one base: a length
of 1 is a caller's placeholder for a missing flank or contig), each at
the least instruction count of the densest exact form: 16-bit cells
two to a 32-bit lane, with Hopper's fused DPX max forms as one
instruction. A local affine-gap cell then needs 6 such operations:
H - gap_open (shared by the E to its right and the F below), E =
max(E' - gap_extend, .) and F likewise (one `viaddmax` each), the
substitution score (one read of a query profile), and H = max(diag +
s, E, F, 0) as `viaddmax_relu` then `vimax`; the best cell's tracking
is not counted. That is 3 lane instructions a cell. The ceiling is the
SM's issue rate: 4 warp instructions a clock, 32 lanes each, times the
card's SMs and its maximum SM clock.
"""

from __future__ import annotations

import numpy as np

HBM_BYTES_PER_S = 3.35e12          # H100 SXM data sheet
SW_LANE_INSTRUCTIONS_PER_CELL = 3
WARP_INSTRUCTIONS_PER_CLOCK = 4
LANES = 32


def sort_bytes(planes) -> int:
    """Bytes a sort call must move: planes given as (numel, itemsize)."""
    return sum(2 * n * size for n, size in planes)


def sort_least_s(nbytes: int) -> float:
    return nbytes / HBM_BYTES_PER_S


def sw_live_cells(qlen, tlen) -> int:
    """Live cells of an SW call from its per-pair lengths."""
    q = np.asarray(qlen, np.int64)
    t = np.asarray(tlen, np.int64)
    return int((q * t)[(q > 1) & (t > 1)].sum())


def issue_ceiling(sms: int, max_sm_clock_hz: float) -> float:
    """Lane instructions a second the card can issue."""
    return WARP_INSTRUCTIONS_PER_CLOCK * LANES * sms * max_sm_clock_hz


def sw_least_s(cells: int, sms: int, max_sm_clock_hz: float) -> float:
    return cells * SW_LANE_INSTRUCTIONS_PER_CELL / issue_ceiling(
        sms, max_sm_clock_hz)


def share(least_s: float, device_s: float):
    """The least time as a percentage of the measured device time, or
    None where nothing was measured."""
    if device_s <= 0:
        return None
    return 100.0 * least_s / device_s


def kernel_share(ctx, label: str):
    """A wrapped kernel's share of its roofline over the traced calls:
    the summed least time of its calls over their summed device time."""
    tr = ctx.trace
    if tr is None or label not in tr.call_device_s:
        return None
    calls = [c for c in ctx.calls if c.label == label]
    dev = tr.call_device_s[label]
    if len(calls) != len(dev):
        return None
    # calls on host tensors launch nothing on the card
    calls, dev = zip(*[(c, d) for c, d in zip(calls, dev)
                       if c.info is not None]) if calls else ((), ())
    if not calls:
        return None
    if label == "sort":
        least = sum(sort_least_s(sort_bytes(c.info)) for c in calls)
    else:
        if ctx.sms is None or ctx.max_sm_clock_hz is None:
            return None
        least = sum(sw_least_s(sw_live_cells(*c.info), ctx.sms,
                               ctx.max_sm_clock_hz) for c in calls)
    return share(least, sum(dev))
