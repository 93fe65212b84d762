"""The traced section of a run: `torch.profiler` over a few units of
work, with the hand kernels' entries (and the host functions an entry
names) wrapped in `record_function` ranges, and the record reduced to
what the per-layer metrics read.

A kernel belongs to a range when the host op that launched it started
inside the range: every CUDA kernel launched inside a call to the
wrapped entry counts for it, whatever its name. The reduction reads
the profiler's events once, in order, and keeps no per-event objects.
"""

from __future__ import annotations

import bisect
import contextlib
import dataclasses
import importlib
import time

RANGE = "portbench::"
WINDOW = RANGE + "window"
TOP = 10


@dataclasses.dataclass
class Call:
    """One call of a wrapped entry: its label, and what `info` made of
    its arguments."""
    label: str
    info: object


@dataclasses.dataclass
class Summary:
    window_s: float
    busy_s: float
    kernels: int
    device_ops: list
    idle_gaps: list
    # label -> device seconds of each call, in call order
    call_device_s: dict
    unattributed_kernels: int


def _wrap(module, attr, label, calls, info):
    import torch
    inner = getattr(module, attr)

    def wrapper(*a, **kw):
        calls.append(Call(label, info(a, kw) if info else None))
        with torch.profiler.record_function(RANGE + label):
            return inner(*a, **kw)

    return inner, wrapper


@contextlib.contextmanager
def wrapped(package: str, targets):
    """Wrap `package`.<module>.<attr> for each (module, attr, label,
    info) of `targets` in a record_function range named after `label`;
    `info(args, kwargs)`, when given, is kept a call. Yields the list of
    Calls; the originals are put back on leaving."""
    calls, undo = [], []
    try:
        for mod, attr, label, info in targets:
            module = importlib.import_module(f"{package}.{mod}")
            inner, wrapper = _wrap(module, attr, label, calls, info)
            setattr(module, attr, wrapper)
            undo.append((module, attr, inner))
        yield calls
    finally:
        for module, attr, inner in reversed(undo):
            setattr(module, attr, inner)


@contextlib.contextmanager
def profiled(attribute=(), cuda: bool = True):
    """Profile the block (host ops, and CUDA activity with `cuda`) inside
    one WINDOW range; yields a dict that holds the Summary under
    "summary" once the block has ended, with the device seconds of each
    call of the wrapped labels in `attribute`."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    out = {}
    acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if cuda else [])
    if cuda:
        torch.cuda.synchronize()
    with profile(activities=acts) as prof:
        with torch.profiler.record_function(WINDOW):
            yield out
            if cuda:
                torch.cuda.synchronize()
    t0 = time.perf_counter()
    out["summary"] = reduce_events(_events(prof), attribute)
    out["reduce_s"] = time.perf_counter() - t0


# the profiler's activity types read: operations that run on the
# device, the host's calls into the CUDA runtime and driver, and host
# ops and ranges (the rest, such as the device-side copies of the
# ranges and the profiler's own overhead, is left out)
DEVICE = {"kernel", "gpu_memcpy", "gpu_memset"}
RUNTIME = {"cuda_runtime", "cuda_driver"}
HOST = {"cpu_op", "user_annotation"}


# device-side events that are not operations: the profiler's
# synchronisation records
SYNC = ("Context Sync", "Stream Sync", "Event Sync", "Stream Wait Event")


def _activity(e, device: bool) -> str:
    """The event's activity type; older torch builds lack
    `activity_type`, and there it is told from the device, the
    annotation flag and the name."""
    if hasattr(e, "activity_type"):
        return e.activity_type()
    name = e.name()
    note = getattr(e, "is_user_annotation", lambda: False)() or \
        name.startswith(RANGE)
    if device:
        if note:
            return "gpu_user_annotation"
        if name.startswith(SYNC):
            return "cuda_sync"
        return "gpu_memcpy" if name.startswith("Memcpy") else \
            "gpu_memset" if name.startswith("Memset") else "kernel"
    if note:
        return "user_annotation"
    if name.startswith(("cuda", "cu")) and "::" not in name:
        return "cuda_runtime"
    return "overhead" if name == "Activity Buffer Request" else "cpu_op"


def _events(prof):
    """(activity, start_ns, end_ns, name, correlation, linked
    correlation, thread) of every event of the record."""
    from torch.autograd import DeviceType
    for e in prof.profiler.kineto_results.events():
        start = e.start_ns()
        act = _activity(e, e.device_type() == DeviceType.CUDA)
        yield (act, start, start + e.duration_ns(), e.name(),
               e.correlation_id(), e.linked_correlation_id(),
               e.start_thread_id())


def _union(intervals):
    """Merged [start, end) intervals of a sorted list."""
    out = []
    for s, e in intervals:
        if out and s <= out[-1][1]:
            if e > out[-1][1]:
                out[-1][1] = e
        else:
            out.append([s, e])
    return out


def _innermost(host, queries):
    """For each query time (sorted), the innermost host event open at
    it: host is [(start, end, name)] sorted by start, properly nested.
    Returns names (None where none is open)."""
    out, stack, i = [], [], 0
    for t in queries:
        while i < len(host) and host[i][0] <= t:
            while stack and stack[-1][1] <= host[i][0]:
                stack.pop()
            stack.append(host[i])
            i += 1
        while stack and stack[-1][1] <= t:
            stack.pop()
        out.append(stack[-1][2] if stack else None)
    return out


def reduce_events(events, attribute=()) -> Summary:
    """The Summary of a profiler record given as `_events` tuples. A
    device op's launch time is its runtime call's (same correlation),
    else the start of the host op it is linked to."""
    host, device, runtime = [], [], {}
    window = None
    for act, s, e, name, corr, linked, tid in events:
        if act in DEVICE:
            device.append((s, e, name, corr, linked, act))
        elif act in RUNTIME:
            runtime[corr] = s
        elif act in HOST:
            host.append((s, e, name, corr, tid))
            if name == WINDOW:
                window = (s, e, tid)
    if window is None:
        raise RuntimeError("the profiler recorded no window range")
    w0, w1, main = window
    device = sorted(d for d in device if d[1] > w0 and d[0] < w1)
    host.sort()
    main_host = [(s, e, name) for s, e, name, _c, tid in host
                 if tid == main and w0 <= s <= w1]
    by_corr = {c: (s, name) for s, _e, name, c, tid in host if c}
    ranges = {}
    for s, e, name in main_host:
        if name.startswith(RANGE) and name != WINDOW:
            ranges.setdefault(name[len(RANGE):], []).append((s, e))

    busy = _union([[max(s, w0), min(e, w1)] for s, e, *_ in device])
    busy_ns = sum(e - s for s, e in busy)
    kernels = sum(1 for d in device if d[5] == "kernel")
    # each device op's launching host op, and its time
    op_time, call_ns, unattributed = {}, {}, 0
    starts = {lab: [s for s, _ in ranges[lab]] for lab in attribute
              if lab in ranges}
    for s, e, name, corr, linked, _act in device:
        host_op = by_corr.get(linked)
        t = runtime.get(corr, host_op[0] if host_op else None)
        label = host_op[1] if host_op else name
        op_time[label] = op_time.get(label, 0) + (e - s)
        if t is None:
            unattributed += 1
            continue
        for lab, st in starts.items():
            i = bisect.bisect_right(st, t) - 1
            if i >= 0 and t <= ranges[lab][i][1]:
                per = call_ns.setdefault(lab, [0] * len(st))
                per[i] += e - s
    # idle time between device ops, by what the host had open: the
    # innermost wrapped range and the innermost host op
    gaps, edge = [], w0
    for s, e in busy:
        if s > edge:
            gaps.append((edge, s))
        edge = max(edge, e)
    if w1 > edge:
        gaps.append((edge, w1))
    mids = [(a + b) // 2 for a, b in gaps]
    inner_op = _innermost(main_host, mids)
    inner_range = _innermost(
        [h for h in main_host if h[2].startswith(RANGE)], mids)
    idle = {}
    for (a, b), rng, op in zip(gaps, inner_range, inner_op):
        lab = f"{rng or WINDOW} / {op if op and op != rng else 'host'}"
        idle[lab] = idle.get(lab, 0) + (b - a)
    top_ops = sorted(op_time.items(), key=lambda kv: -kv[1])[:TOP]
    top_idle = sorted(idle.items(), key=lambda kv: -kv[1])[:TOP]
    return Summary(
        window_s=(w1 - w0) / 1e9, busy_s=busy_ns / 1e9, kernels=kernels,
        device_ops=[[n[:120], v / 1e9] for n, v in top_ops],
        idle_gaps=[[n[:120], v / 1e9] for n, v in top_idle],
        call_device_s={lab: [v / 1e9 for v in per]
                       for lab, per in call_ns.items()},
        unattributed_kernels=unattributed)
