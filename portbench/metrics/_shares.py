"""Readings shared by the per-layer readers: the device's idle share
over the traced section."""

from __future__ import annotations


def idle_share(ctx):
    """100 x (1 - device busy time / traced wall time), where busy time
    is the union of the device's operation intervals; None without a
    device trace."""
    tr = ctx.trace
    if tr is None or tr.window_s <= 0 or tr.busy_s <= 0:
        return None
    return 100.0 * (1.0 - tr.busy_s / tr.window_s)
