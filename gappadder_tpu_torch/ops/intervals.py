"""Batched interval membership join (counterpart of
gappadder_tpu/ops/intervals.py).

Windows are sorted by (tid, start); reads and window starts are sorted
together on (tid, pos, tag) with windows first at equal positions; a
cumsum of window tags gives, per read, how many windows start at or
before it; the `fanout` windows before that count are checked for
start <= pos <= end with a matching tid. `max_overlap_np` gives the
host the true maximum overlap, so that `fanout` drops no hit.
"""

from __future__ import annotations

import torch

from . import psort

INT_MAX = 0x7FFFFFFF


def sort_windows(tid, start, end, *payloads):
    """Sort window columns by (tid, start); payloads ride along.
    Returns int32 columns (tid, start, end, *payloads)."""
    cols = (tid, start, end) + tuple(payloads)
    res = psort.bitonic_sort(tuple(c.to(torch.int64) for c in cols),
                             num_keys=2)
    return tuple(r.to(torch.int32) for r in res)


def interval_join(rtid, rpos, wtid, wstart, wend, fanout: int = 8):
    """For each read, indices of up to `fanout` windows containing it:
    int64 [N, fanout], window index or -1. Windows are sorted by
    (tid, start); padding rows have tid == INT_MAX."""
    N = rtid.shape[0]
    W = wtid.shape[0]
    dev = rtid.device
    i64 = torch.int64
    tag = torch.cat([torch.zeros(W, dtype=i64, device=dev),
                     torch.ones(N, dtype=i64, device=dev)])
    keys_tid = torch.cat([wtid, rtid]).to(i64)
    keys_pos = torch.cat([wstart, rpos]).to(i64)
    payload = torch.cat([torch.arange(W, device=dev),
                         torch.arange(N, device=dev)])
    _, _, stag, spay = psort.bitonic_sort(
        (keys_tid, keys_pos, tag, payload), num_keys=3)
    nwin_before = torch.cumsum((stag == 0).to(i64), dim=0)
    tgt = torch.where(stag == 1, spay, torch.full_like(spay, N))
    hi = torch.zeros(N + 1, dtype=i64, device=dev).scatter_(
        0, tgt, nwin_before)[:N]

    offs = torch.arange(fanout, device=dev)
    cand = hi[:, None] - 1 - offs[None, :]                   # [N, K]
    cc = cand.clamp(0, max(W - 1, 0))
    ok = (cand >= 0) & (wtid[cc] == rtid[:, None]) & \
        (wstart[cc] <= rpos[:, None]) & (rpos[:, None] <= wend[cc])
    return torch.where(ok, cand, torch.full_like(cand, -1))


def max_overlap_np(tid, start, end) -> int:
    """Host helper: the most windows overlapping any one position (the
    `fanout` to ask for), at least 1."""
    if len(tid) == 0:
        return 1
    events = []
    for t, s, e in zip(tid, start, end):
        events.append((int(t), int(s), 0))
        events.append((int(t), int(e) + 1, 1))
    events.sort()
    best = cur = 0
    for _, _, kind in events:
        cur += 1 if kind == 0 else -1
        best = max(best, cur)
    return max(best, 1)
