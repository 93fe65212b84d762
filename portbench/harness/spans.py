"""The program's own spans in a traced section's profiler record: each
`gappadder::` range (the port's `utils/meters.span`) on the main thread
inside the window, reduced by name to

  calls     the number of its calls
  wall_s    their host seconds
  self_s    wall_s less the program spans directly inside them
  kernels   CUDA kernels launched while a call is open
  device_s  device seconds of every operation launched while a call is
            open (kernels, copies and sets)
  idle_s    the device's idle time inside its calls: each idle gap of
            the device timeline is split at the span's edges
  syncs     host-blocking runtime calls made while a call is open
            (cudaStreamSynchronize, cudaDeviceSynchronize,
            cudaEventSynchronize, cudaMemcpy without Async)

A device operation's launch time is its runtime call's (same
correlation), else the start of the host op it is linked to, as
`trace.reduce_events` takes it for `call_device_s`; nested calls of one
name count once. The record is `trace._events`' tuples; the ranges run
on the profiler's clock, so no second clock is read.
"""

from __future__ import annotations

import dataclasses

import numpy as np

from portbench.harness.trace import DEVICE, HOST, RUNTIME, WINDOW, _union

PROGRAM = "gappadder::"
BLOCKING = ("cudaStreamSynchronize", "cudaDeviceSynchronize",
            "cudaEventSynchronize")


@dataclasses.dataclass
class SpanStats:
    calls: int
    wall_s: float
    self_s: float
    kernels: int
    device_s: float
    idle_s: float
    syncs: int


def blocks(name: str) -> bool:
    """Whether a runtime call makes the host wait for the device."""
    return name in BLOCKING or (name.startswith("cudaMemcpy")
                                and "Async" not in name)


def _inside(starts, ends, t):
    """Mask of the times `t` inside one of the disjoint sorted intervals
    [starts, ends]."""
    i = np.searchsorted(starts, t, side="right") - 1
    return (i >= 0) & (t <= ends[np.clip(i, 0, None)])


def _idle_before(ga, gb, cum, x):
    """Idle time before each time of `x`, over the disjoint sorted idle
    gaps [ga, gb) with `cum` their lengths' running sum from 0."""
    k = np.searchsorted(ga, x, side="right")
    last = np.clip(k - 1, 0, None)
    part = np.where(k > 0, np.minimum(gb[last], x) - ga[last], 0)
    return cum[last] * (k > 0) + part


def reduce_spans(events) -> dict:
    """{span name: SpanStats} of a profiler record given as
    `trace._events` tuples."""
    host, device, runtime, waits = [], [], {}, []
    window = None
    for act, s, e, name, corr, linked, tid in events:
        if act in DEVICE:
            # an older torch classes the device copy of a range as a
            # kernel (see trace._activity)
            if not name.startswith(PROGRAM):
                device.append((s, e, corr, linked, act == "kernel"))
        elif act in RUNTIME:
            runtime[corr] = s
            if blocks(name):
                waits.append(s)
        elif act in HOST:
            host.append((s, e, name, corr, tid))
            if name == WINDOW:
                window = (s, e, tid)
    if window is None:
        raise RuntimeError("the profiler recorded no window range")
    w0, w1, main = window
    by_corr = {c: s for s, _e, _n, c, _t in host if c}
    calls = sorted(((s, e, name[len(PROGRAM):]) for s, e, name, _c, tid
                    in host if tid == main and w0 <= s <= w1
                    and name.startswith(PROGRAM)),
                   key=lambda c: (c[0], -c[1]))
    if not calls:
        return {}

    device = [d for d in device if d[1] > w0 and d[0] < w1]
    busy = _union(sorted([max(s, w0), min(e, w1)] for s, e, *_ in device))
    gaps, edge = [], w0
    for s, e in busy:
        if s > edge:
            gaps.append((edge, s))
        edge = max(edge, e)
    if w1 > edge:
        gaps.append((edge, w1))
    ga = np.array([a for a, _ in gaps] or [w1], np.int64)
    gb = np.array([b for _, b in gaps] or [w1], np.int64)
    cum = np.concatenate([[0], np.cumsum(gb - ga)[:-1]])

    launch = [(runtime.get(corr, by_corr.get(linked)), e - s, kern)
              for s, e, corr, linked, kern in device]
    launch = [x for x in launch if x[0] is not None]
    t = np.array([x[0] for x in launch], np.int64)
    dur = np.array([x[1] for x in launch], np.int64)
    kern = np.array([x[2] for x in launch], bool)
    waits = np.array(sorted(waits), np.int64)

    # wall and self time, by the program span directly around each call
    wall, inner, stack = {}, {}, []
    for s, e, name in calls:
        while stack and stack[-1][1] <= s:
            stack.pop()
        if stack:
            inner[stack[-1][2]] = inner.get(stack[-1][2], 0) + (e - s)
        wall[name] = wall.get(name, 0) + (e - s)
        stack.append((s, e, name))
    out = {}
    for name in wall:
        merged = _union([[s, e] for s, e, n in calls if n == name])
        st = np.array([s for s, _ in merged], np.int64)
        en = np.array([e for _, e in merged], np.int64)
        hit = _inside(st, en, t)
        idle = _idle_before(ga, gb, cum, en) - _idle_before(ga, gb, cum, st)
        out[name] = SpanStats(
            calls=sum(n == name for _s, _e, n in calls),
            wall_s=wall[name] / 1e9,
            self_s=(wall[name] - inner.get(name, 0)) / 1e9,
            kernels=int((hit & kern).sum()),
            device_s=int(dur[hit].sum()) / 1e9,
            idle_s=int(idle.sum()) / 1e9,
            syncs=int(_inside(st, en, waits).sum()))
    return out


def table(spans: dict) -> dict:
    """The spans as plain values, for a log line."""
    return {name: dataclasses.asdict(v) for name, v in spans.items()}
