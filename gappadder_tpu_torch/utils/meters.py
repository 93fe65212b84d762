"""Tracing and metering (counterpart of gappadder_tpu/utils/meters.py).

One primitive, `span(name)`, marks a part of the program: the step's
blocks, block 3's k-mer and DBG parts, Collect's parts, the Assembly
driver's parts and the CLI's stages. A span does two things, each only
when someone is listening:

  * while a `torch.profiler` is recording (the CLI's `--trace DIR`, or
    any caller's own profiler), it opens the range
    `torch.profiler.record_function("gappadder::" + name)`. The range
    lives in the profiler's own record, on the clock the profiler puts
    the CUDA kernels, copies and runtime calls on (the shared clock), so
    every idle gap of the device timeline can be put down to the
    program span open at that moment, with no second clock and no
    device sync;
  * while a `Meters` is current (the CLI makes one a call), it adds its
    host seconds to that Meters under its own name, with the counts
    given through its handle (`s.add(records=n)`).

With neither, a span costs one check of the profiler's flag. A span
never synchronises and never reads a device value. Its host seconds
are the host's work plus the time to enqueue device work, not the
device's time.

`metrics.json` (`Meters.dump`) holds one CLI call's spans:
{"total_seconds": s, "stages": {name: {"seconds": s, counts...}}}.
`device_trace` writes a Chrome trace of a block (`--trace DIR`).
"""

from __future__ import annotations

import contextlib
import functools
import json
import os
import time

import torch
from torch.autograd import profiler as _profiler

PREFIX = "gappadder::"
_clock = time.perf_counter
TRACE_FILE = "trace.json"

# the Meters of the CLI call in progress (None: no call is metering)
_current: Meters | None = None


class Meters:
    """Host seconds and counts by span name, for one CLI call. `with
    Meters() as m:` makes it the current Meters for the block."""

    def __init__(self):
        self.stages: dict[str, dict] = {}
        self._t0 = time.perf_counter()
        self._outer: Meters | None = None

    def __enter__(self):
        global _current
        self._outer, _current = _current, self
        return self

    def __exit__(self, *exc):
        global _current
        _current = self._outer
        return False

    def summary(self) -> dict:
        return {"total_seconds": time.perf_counter() - self._t0,
                "stages": self.stages}

    def dump(self, path: str) -> None:
        with open(path, "w") as fh:
            json.dump(self.summary(), fh, indent=2)

    def report(self) -> str:
        lines = []
        for name, rec in self.stages.items():
            extras = " ".join(f"{k}={v:.1f}" if isinstance(v, float)
                              else f"{k}={v}"
                              for k, v in rec.items() if k != "seconds")
            lines.append(f"  {name}: {rec['seconds']:.2f}s {extras}")
        return "\n".join(lines)


class _Timed:
    """A span a Meters listens to: its host seconds and counts go to the
    Meters' record `rec` of its name."""

    __slots__ = ("_rec", "_t0")

    def __init__(self, rec: dict):
        self._rec = rec

    def __enter__(self):
        self._t0 = _clock()
        return self

    def __exit__(self, *exc):
        self._rec["seconds"] += _clock() - self._t0
        return False

    def add(self, **counts) -> None:
        rec = self._rec
        for k, v in counts.items():
            rec[k] = rec.get(k, 0) + v

    def set(self, **values) -> None:
        self._rec.update(values)


class _Off:
    """The span no one listens to: does nothing."""

    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False

    def add(self, **counts) -> None:
        pass

    def set(self, **values) -> None:
        pass


_OFF = _Off()


class _Ranged:
    """A span while a profiler records: a `gappadder::` range around the
    span's timing (`_Timed`, or `_OFF` without a Meters)."""

    __slots__ = ("_range", "_timed")

    def __init__(self, name: str, timed):
        self._range = torch.profiler.record_function(PREFIX + name)
        self._timed = timed

    def __enter__(self):
        self._range.__enter__()
        return self._timed.__enter__()

    def __exit__(self, *exc):
        self._timed.__exit__(*exc)
        self._range.__exit__(*exc)
        return False


def span(name: str):
    """`with span(name) as s:` marks a part of the program (see the
    module's docstring); `s.add(**counts)` adds counts and
    `s.set(**values)` records levels under the span's name in the
    current Meters (both no-ops without one). With no profiler
    recording and no current Meters it is one shared object that does
    nothing. `spanned(name)` is the decorator form."""
    m = _current
    if m is None:
        timed = _OFF
    else:
        rec = m.stages.get(name)
        if rec is None:
            rec = m.stages[name] = {"seconds": 0.0}
        timed = _Timed(rec)
    if _profiler._is_profiler_enabled:
        return _Ranged(name, timed)
    return timed


def spanned(name: str):
    """Decorator: each call of the function runs inside `span(name)`."""
    def wrap(fn):
        @functools.wraps(fn)
        def inner(*args, **kwargs):
            with span(name):
                return fn(*args, **kwargs)
        return inner
    return wrap


def memory(s, device) -> None:
    """Record on `s` the card's allocated bytes now and the process's
    peak so far (the peak counter is never reset here); nothing for a
    CPU device."""
    device = torch.device(device)
    if device.type == "cuda":
        s.set(device_bytes=torch.cuda.memory_allocated(device),
              device_peak_bytes=torch.cuda.max_memory_allocated(device))


@contextlib.contextmanager
def device_trace(logdir: str | None, device="cuda"):
    """A `torch.profiler` trace of the block, exported as a Chrome trace
    to `<logdir>/trace.json` (no-op when logdir is None). Records CPU
    activity, and CUDA activity when `device` is a CUDA device; the
    program's spans appear in it as `gappadder::` ranges."""
    if logdir is None:
        yield
        return
    from torch.profiler import ProfilerActivity, profile
    acts = [ProfilerActivity.CPU]
    if torch.device(device).type == "cuda":
        acts.append(ProfilerActivity.CUDA)
    os.makedirs(logdir, exist_ok=True)
    with profile(activities=acts) as prof:
        yield
        if torch.device(device).type == "cuda":
            torch.cuda.synchronize()
    prof.export_chrome_trace(os.path.join(logdir, TRACE_FILE))
