"""Each entry's set-up, window and check at a small size on the CPU,
traced and not, and a cell and a per-layer metric added by adding files
and BENCHMARK.json entries alone."""

import json
import pathlib
import shutil
import subprocess
import sys

import pytest

from portbench.tests.conftest import run_cell

ROOT = pathlib.Path(__file__).resolve().parents[2]


@pytest.mark.parametrize("cell,trace", [("chr14.step", 0), ("chr14.step", 1),
                                        ("ecoli.collect", 0),
                                        ("ecoli.collect", 1)])
def test_a_small_run_is_correct_and_reports_its_metrics(cell, trace):
    rc, res = run_cell(cell, seed=2**31 + 11, trace=trace)
    assert rc == 0 and res["correct"] is True, res and res["checks"]
    assert res["attempted"] >= 1 and res["failed"] == 0
    assert list(res)[-1] == "checks"
    assert all(c["value"] <= c["limit"] for c in res["checks"].values())
    b = json.loads((ROOT / "BENCHMARK.json").read_text())
    if trace:
        assert res["device"]["window_s"] > 0 and "breakdown" in res
        # no device on the CPU: device readings are left out, not 0
        assert all("roofline" not in m and "idle_share" not in m
                   for m in res["metrics"])
    else:
        want = {m["name"] for m in b["end_to_end"]
                if cell in m.get("workloads", [cell])}
        assert set(res["metrics"]) == want
        assert all(m["value"] > 0 for m in res["metrics"].values())


NEW_CELL = {"config": "hs_chr14", "entry": "step", "generator": "gap_batches",
            "traffic": {"traced_steps": 2, "checked_steps": 1},
            "why": "a smaller sample of the step"}
NEW_METRIC = '''"""Median wall seconds of a window step."""


def read(ctx):
    walls = sorted(u["wall_s"] for u in ctx.units)
    return walls[len(walls) // 2] if walls else None
'''
DRIVER = """
import io, json, sys
sys.path.insert(0, sys.argv[1])
from portbench.harness import bench
from portbench.tests.conftest import TINY
for trace in (0, 1):
    out = io.StringIO()
    rc = bench.main(["--workload", "chr14.step_small", "--seed", "5",
                     "--seconds", "0", "--trace", str(trace)], device="cpu",
                    scale=TINY["chr14.step"], out=out)
    print(rc, out.getvalue().strip())
"""


def test_a_new_cell_and_metric_are_picked_up_from_files(tmp_path):
    shutil.copytree(ROOT / "portbench", tmp_path / "portbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    # the checkout's program, as it would be there
    (tmp_path / "gappadder_tpu_torch").symlink_to(ROOT / "gappadder_tpu_torch")
    b = json.loads((ROOT / "BENCHMARK.json").read_text())
    b["workloads"].append({"name": "chr14.step_small", "config": "hs_chr14",
                           "traffic": "gap_batches_small", "chips": 1,
                           "why": NEW_CELL["why"]})
    for m in b["end_to_end"]:
        if m["name"] in ("step_gaps_per_s", "step_ms.p95"):
            m["workloads"].append("chr14.step_small")
    b["per_layer"].append({"name": "step_wall_s.median", "unit": "s",
                           "better": "lower", "source": "host_clock",
                           "layer": "step",
                           "moves": "step_gaps_per_s",
                           "workloads": ["chr14.step_small"]})
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(b))
    (tmp_path / "portbench" / "workloads" / "chr14.step_small.json"
     ).write_text(json.dumps(NEW_CELL))
    (tmp_path / "portbench" / "metrics" / "step_wall_s.median.py"
     ).write_text(NEW_METRIC)
    out = subprocess.run([sys.executable, "-c", DRIVER, str(tmp_path)],
                         capture_output=True, text=True, timeout=600,
                         cwd=tmp_path)
    assert out.returncode == 0, out.stderr[-3000:]
    lines = [ln for ln in out.stdout.splitlines() if ln[:2] == "0 "]
    plain, traced = (json.loads(ln[2:]) for ln in lines)
    assert plain["correct"] and traced["correct"]
    assert set(plain["metrics"]) == {"step_gaps_per_s", "step_ms.p95",
                                     "setup_s"}
    assert set(traced["metrics"]) == {"step_wall_s.median"}
    assert traced["metrics"]["step_wall_s.median"]["value"] > 0
