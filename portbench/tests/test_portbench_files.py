"""BENCHMARK.json and the files it names: every configuration, workload
and metric file loads by name, names and units keep their character
rules, every cell reports set-up time, another end-to-end metric and a
per-layer metric, and the whole check fits its time budget."""

import json
import pathlib
import re

import pytest

from portbench.harness import bench

ROOT = pathlib.Path(__file__).resolve().parents[2]
B = json.loads((ROOT / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
SOURCES = {"device_trace", "program_span", "program_counter", "host_clock"}
KEYS = {"configs": {"name", "source", "file", "reduced", "why"},
        "workloads": {"name", "config", "traffic", "chips", "why"},
        "end_to_end": {"name", "unit", "better", "bound", "source"},
        "per_layer": {"name", "unit", "better", "source", "layer", "moves"}}


def line(s, most=200):
    return isinstance(s, str) and 1 <= len(s) <= most and "\n" not in s \
        and "\t" not in s


def test_top_level_keys_and_paths():
    assert set(B) == {"command", "paths", "run_seconds", "configs",
                      "workloads", "end_to_end", "per_layer"}
    assert B["command"][:2] == ["python3", "portbench/run.py"]
    assert all(line(w) for w in B["command"]) and len(B["command"]) <= 32
    assert B["paths"] == ["portbench"]
    assert isinstance(B["run_seconds"], int) and 1 <= B["run_seconds"] <= 51
    assert len((ROOT / "BENCHMARK.json").read_bytes()) <= 64 * 1024


@pytest.mark.parametrize("kind", sorted(KEYS))
def test_entries_keep_their_keys_and_name_rules(kind):
    b = B
    names = [e["name"] for e in b[kind]]
    assert len(names) == len(set(names))
    for e in b[kind]:
        assert set(e) - {"workloads"} == KEYS[kind], e["name"]
        assert NAME.match(e["name"]), e["name"]
        if "unit" in e:
            assert UNIT.match(e["unit"]) and e["better"] in ("lower",
                                                             "higher")
            assert e["source"] in SOURCES
        for k in ("why", "layer", "source"):
            if k in e:
                assert line(e[k]), (e["name"], k)


def test_configurations_load_by_name():
    for c in B["configs"]:
        path = ROOT / c["file"]
        assert c["file"].startswith("portbench/configs/")
        cfg = json.loads(path.read_text())
        assert cfg["name"] == c["name"] and cfg["reduced"] == c["reduced"]
        assert len(c["reduced"]) <= 16 and all(NAME.match(k)
                                               for k in c["reduced"])
        assert c["name"] in {w["config"] for w in B["workloads"]}
    assert len({c["source"] for c in B["configs"]}) == len(B["configs"])


def test_workloads_load_by_name_and_name_their_entry():
    pairs = set()
    for w in B["workloads"]:
        _b, spec, wl, cfg = bench.load_cell(w["name"])
        assert spec is not None and wl["config"] == w["config"]
        assert (ROOT / "portbench" / "entries" / f"{wl['entry']}.py").exists()
        assert (ROOT / "portbench" / "traffic"
                / f"{wl['generator']}.py").exists()
        assert NAME.match(w["traffic"]) and w["chips"] in (1, 4)
        pairs.add((w["config"], w["traffic"]))
    assert len(pairs) == len(B["workloads"])
    assert sum(w["chips"] == 4 for w in B["workloads"]) <= max(
        1, len(B["workloads"]) // 4)


def test_metric_readers_load_by_name():
    for m in B["per_layer"]:
        mod = bench.load_module(ROOT / "portbench" / "metrics"
                                / f"{m['name']}.py", "m_" + m["name"])
        assert callable(mod.read)


def test_every_cell_reports_what_the_contract_asks():
    e2e = {m["name"]: m for m in B["end_to_end"]}
    assert "setup_s" in e2e and e2e["setup_s"]["bound"] <= 0.25
    for m in B["end_to_end"]:
        assert 0.01 <= m["bound"] <= 0.25
        assert m["source"] in ("host_clock", "device_trace")
    for m in B["per_layer"]:
        assert m["moves"] in e2e and m["moves"] != "setup_s"
        for cell in m["workloads"]:
            reported = [x["name"] for x in bench.cell_metrics(
                B, cell, "end_to_end")]
            assert m["moves"] in reported, (m["name"], cell)
    for w in B["workloads"]:
        names = [x["name"] for x in bench.cell_metrics(B, w["name"],
                                                        "end_to_end")]
        assert "setup_s" in names and len(names) >= 2, w["name"]
        assert bench.cell_metrics(B, w["name"], "per_layer"), w["name"]


def test_a_full_check_fits_its_budget_with_24_cells():
    runs = 2 + 14 * 24
    total = runs * (B["run_seconds"] + 60) + 24 * 2 * 90 + 1200
    assert total <= 43200


def test_files_under_paths_are_named_from_name_characters():
    for p in (ROOT / "portbench").rglob("*"):
        if "__pycache__" in p.parts or not p.is_file():
            continue
        rel = p.relative_to(ROOT).as_posix()
        assert re.match(r"^[A-Za-z0-9_./-]+$", rel) and len(rel) <= 200, rel
