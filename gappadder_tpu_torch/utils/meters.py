"""Tracing and metering (counterpart of gappadder_tpu/utils/meters.py).

Per-stage wall-clock seconds and item counters (reads/s, gaps/s), a
JSON metrics dump a run (`metrics.json`), and an optional
`torch.profiler` trace of the run for device timelines.
"""

from __future__ import annotations

import contextlib
import json
import os
import time


class Meters:
    def __init__(self):
        self.stages: dict[str, dict] = {}
        self._t0 = time.time()

    @contextlib.contextmanager
    def stage(self, name: str, **counts):
        t0 = time.time()
        rec = self.stages.setdefault(name, {"seconds": 0.0})
        try:
            yield rec
        finally:
            dt = time.time() - t0
            rec["seconds"] += dt
            for k, v in counts.items():
                rec[k] = rec.get(k, 0) + v
                if v and dt > 0:
                    rec[f"{k}_per_s"] = rec[k] / rec["seconds"]

    def count(self, stage: str, **counts):
        rec = self.stages.setdefault(stage, {"seconds": 0.0})
        for k, v in counts.items():
            rec[k] = rec.get(k, 0) + v
            if rec["seconds"] > 0:
                rec[f"{k}_per_s"] = rec[k] / rec["seconds"]

    def summary(self) -> dict:
        return {"total_seconds": time.time() - self._t0,
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


GLOBAL = Meters()

TRACE_FILE = "trace.json"


@contextlib.contextmanager
def device_trace(logdir: str | None, device="cuda"):
    """A `torch.profiler` trace of the block, exported as a Chrome trace
    to `<logdir>/trace.json` (no-op when logdir is None). Records CPU
    activity, and CUDA activity when `device` is a CUDA device."""
    if logdir is None:
        yield
        return
    import torch
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
