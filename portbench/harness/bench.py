"""One run of one benchmark cell, as `portbench/run.py` starts it:

    python3 portbench/run.py --workload <cell> --seed <n> --seconds <s>
        --trace <0|1>

Everything that belongs to a cell is found by name: the cell's entry in
BENCHMARK.json (its chips, and the metrics that name it), its workload
file `portbench/workloads/<cell>.json` (configuration, entry, traffic),
the configuration `portbench/configs/<config>.json`, the entry
`portbench/entries/<entry>.py` and one reader a per-layer metric,
`portbench/metrics/<metric>.py`.

A run: set-up (imports, the kernels built or loaded from the
checkout's build/, the entry's inputs made from the seed, warm-up);
then a closed loop with one caller for `--seconds`: the next unit of
work starts when the last one is done, and the window ends at the end
of the last whole unit that started inside it, so a rate is all the
finished work over all of the window's time. With `--trace 1` a traced
section follows: a few more units under `torch.profiler`, from which
the per-layer metrics are read. Then the program's state is freed and
the outputs are held to the plain reference (`portbench/reference/`).

The last line of standard output is the result; the last lines of
standard error are the numbers compared, each beside its limit.
"""

from __future__ import annotations

import argparse
import contextlib
import importlib
import importlib.util
import json
import os
import pathlib
import sys
import time
import types

HERE = pathlib.Path(__file__).resolve().parent.parent
ROOT = HERE.parent
PROGRAM = "gappadder_tpu_torch"
FORBIDDEN = ("jax", "jaxlib", "flax", "gappadder_tpu")
# caches the program or torch may write: fixed paths inside the checkout
CACHE_DIRS = {"TORCH_EXTENSIONS_DIR": "build/torch_extensions",
              "TRITON_CACHE_DIR": "build/triton"}


def process_start() -> float:
    """The wall-clock time this process started, from /proc."""
    try:
        with open("/proc/self/stat") as fh:
            ticks = int(fh.read().rsplit(")", 1)[1].split()[19])
        with open("/proc/uptime") as fh:
            up = float(fh.read().split()[0])
        return time.time() - up + ticks / os.sysconf("SC_CLK_TCK")
    except (OSError, ValueError, IndexError):
        return time.time()


def load_json(path) -> dict:
    with open(path) as fh:
        return json.load(fh)


def load_module(path, name: str):
    """A module from a file of the benchmark, loaded by its path (file
    names may hold dots)."""
    spec = importlib.util.spec_from_file_location(name, path)
    if spec is None:
        raise FileNotFoundError(path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def benchmark() -> dict:
    return load_json(ROOT / "BENCHMARK.json")


def cell_metrics(bench: dict, cell: str, kind: str) -> list:
    """The metrics of `kind` ("end_to_end" or "per_layer") this cell
    reports: those that list it, or list no cells."""
    return [m for m in bench[kind] if cell in m.get("workloads", [cell])]


def load_cell(cell: str):
    """(BENCHMARK.json entry, workload, configuration) of a cell."""
    bench = benchmark()
    entry = next((w for w in bench["workloads"] if w["name"] == cell), None)
    if entry is None:
        raise KeyError(f"no cell {cell!r} in BENCHMARK.json")
    workload = load_json(HERE / "workloads" / f"{cell}.json")
    config = load_json(HERE / "configs" / f"{workload['config']}.json")
    if workload["config"] != entry["config"]:
        raise ValueError(f"{cell}: workload file names configuration "
                         f"{workload['config']}, BENCHMARK.json "
                         f"{entry['config']}")
    return bench, entry, workload, config


def forbidden_modules() -> list:
    """Loaded modules whose top-level name is one the port must never
    load, compared whole."""
    return sorted({m.split(".")[0] for m in sys.modules} & set(FORBIDDEN))


class Run:
    """What an entry sees of the run: the cell's files, the seed, the
    device, a scratch root under TMPDIR and the set-up parts' clock."""

    def __init__(self, cell, seed, seconds, trace, device, scale):
        self.bench, self.entry_spec, self.workload, self.config = \
            load_cell(cell)
        self.cell, self.seed, self.seconds = cell, seed, seconds
        self.trace, self.device = trace, device
        # at a small size for tests: overrides of the configuration's
        # and the traffic's numbers (never reached from the command line)
        if scale:
            self.config = dict(self.config, **scale.get("config", {}))
            self.workload = dict(self.workload, traffic=dict(
                self.workload["traffic"], **scale.get("traffic", {})))
        self.setup_parts: dict = {}
        self._mark = time.time()

    def part(self, name: str) -> None:
        """Close the set-up part `name` at now."""
        now = time.time()
        self.setup_parts[name] = self.setup_parts.get(name, 0.0) + \
            now - self._mark
        self._mark = now

    def log(self, **kw) -> None:
        print(json.dumps({"portbench": self.cell, **kw}), file=sys.stderr,
              flush=True)


def parse(argv):
    p = argparse.ArgumentParser(prog="portbench/run.py")
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return p.parse_args(argv)


def main(argv=None, *, device: str | None = None, scale: dict | None = None,
         out=None) -> int:
    """Run one cell once. `device` and `scale` are for tests on the CPU
    at a small size; the command line runs on the card at the cell's
    size. Returns the exit code; the result goes to `out` (standard
    output)."""
    started = process_start()
    args = parse(argv)
    out = out or sys.stdout
    with contextlib.redirect_stdout(sys.stderr):
        result, checks = run(args, started, device, scale)
    if result is None:
        return 2
    for name, value, limit in checks:
        print(f"check {name} {value} limit {limit}", file=sys.stderr)
    print(json.dumps(result), file=out, flush=True)
    return 0


def run(args, started: float, device, scale):
    """Set-up, window, traced section and check. Returns (result line,
    checks), or (None, None) where the run must print no result."""
    for var, rel in CACHE_DIRS.items():
        os.environ[var] = str(ROOT / rel)
    sys.path.insert(0, str(ROOT))
    import torch
    bench, spec, _wl, _cfg = load_cell(args.workload)
    on_card = device is None
    if on_card:
        if not torch.cuda.is_available() or \
                torch.cuda.device_count() < spec["chips"]:
            print(f"portbench: {args.workload} needs {spec['chips']} CUDA "
                  f"device(s), found "
                  f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}",
                  file=sys.stderr)
            return None, None
        device = "cuda:0"
    r = Run(args.workload, args.seed, args.seconds, args.trace,
            torch.device(device), scale)
    r._mark = started
    program = importlib.import_module(PROGRAM)
    if ROOT not in pathlib.Path(os.path.abspath(program.__file__)).parents:
        print(f"portbench: {PROGRAM} was loaded from {program.__file__}, "
              f"not from this checkout", file=sys.stderr)
        return None, None
    r.part("imports")
    if on_card:
        from gappadder_tpu_torch.ops import cuda_build
        cuda_build.build_all()
        for name in ("sw", "sort"):
            cuda_build.load(name)
        torch.cuda.reset_peak_memory_stats()
    r.part("kernel_load")
    ent = importlib.import_module(
        f"portbench.entries.{r.workload['entry']}").Entry(r)
    ent.setup()
    window_start = time.time()
    setup_s = window_start - started

    units = []
    w0 = time.perf_counter()
    while not units or time.perf_counter() - w0 < args.seconds:
        u0 = time.perf_counter()
        ent.unit()
        units.append((u0 - w0, time.perf_counter() - w0))
    window_s = units[-1][1]
    r.log(window_s=window_s, units=len(units))

    summary, calls, reduce_s = None, [], None
    if args.trace:
        from . import trace
        with trace.wrapped(PROGRAM, ent.trace_targets()) as calls:
            with trace.profiled(("sort", "sw"), cuda=on_card) as prof:
                ent.traced_units()
        summary, reduce_s = prof["summary"], prof["reduce_s"]
        for c in calls:
            if isinstance(c.info, tuple):
                c.info = tuple(x.cpu().numpy() if torch.is_tensor(x) else x
                               for x in c.info)
        r.log(trace_reduce_s=reduce_s, unattributed_kernels=
              summary.unattributed_kernels, kernels=summary.kernels,
              calls={lab: [sum(c.label == lab for c in calls),
                           len(summary.call_device_s.get(lab, ())),
                           sum(summary.call_device_s.get(lab, ()))]
                     for lab in ("sort", "sw")})

    bad = forbidden_modules()
    if bad:
        print(f"portbench: the run loaded {bad}", file=sys.stderr)
        return None, None
    peak = torch.cuda.max_memory_allocated(device) if on_card else 0
    ent.release()
    if on_card:
        torch.cuda.empty_cache()
    t = time.time()
    checks, compared, failed = ent.check()
    r.log(check_s=time.time() - t, units_compared=compared)

    if args.trace:
        props = torch.cuda.get_device_properties(0) if on_card else None
        ctx = types.SimpleNamespace(
            trace=summary, calls=calls, units=ent.unit_records(),
            traced_units=ent.traced_count,
            sms=props.multi_processor_count if props else None,
            max_sm_clock_hz=max_sm_clock_hz() if on_card else None)
        metrics = {}
        for m in cell_metrics(bench, args.workload, "per_layer"):
            reader = load_module(HERE / "metrics" / f"{m['name']}.py",
                                 f"portbench_metric_{m['name']}")
            value = reader.read(ctx)
            if value is not None:
                metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    else:
        e2e = ent.end_to_end(units, window_s)
        e2e["setup_s"] = setup_s
        metrics = {m["name"]: {"value": e2e[m["name"]], "unit": m["unit"]}
                   for m in cell_metrics(bench, args.workload, "end_to_end")}
    dev = {"platform": "gpu" if on_card else "cpu",
           "kind": torch.cuda.get_device_name(0) if on_card else "cpu",
           "count": 1, "memory_peak_bytes": peak}
    result = {"correct": all(v <= lim for _n, v, lim in checks),
              "attempted": len(units) + ent.traced_count * args.trace,
              "failed": failed, "metrics": metrics,
              "device": dev}
    if summary is not None:
        dev["busy_s"] = summary.busy_s
        dev["window_s"] = summary.window_s
        result["breakdown"] = {"device_ops": summary.device_ops,
                               "idle_gaps": summary.idle_gaps}
    result["setup_parts"] = dict(r.setup_parts, setup_s=setup_s)
    result["checks"] = {n: {"value": v, "limit": lim}
                        for n, v, lim in checks}
    return result, checks


def max_sm_clock_hz():
    """The card's maximum SM clock, from nvidia-smi (None where it
    cannot be read)."""
    import subprocess
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=clocks.max.sm",
             "--format=csv,noheader,nounits"], capture_output=True,
            text=True, timeout=30, check=True).stdout
        return float(out.split()[0]) * 1e6
    except (OSError, subprocess.SubprocessError, ValueError, IndexError):
        return None
