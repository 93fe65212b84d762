"""The reader of `evaluate_cells_per_s.assembly` on hand-made unit
records: the `cells` of each unit's `assembly.evaluate` span over its
seconds, the median over the units, and nothing where no unit counts
cells (a program without the count)."""

import json
import types

import pytest

from portbench.harness.bench import HERE, ROOT, load_module

NAME = "evaluate_cells_per_s.assembly"


def reader():
    return load_module(HERE / "metrics" / f"{NAME}.py", "m_" + NAME)


def test_reads_the_median_rate_of_the_units():
    units = [{"stages": {"assembly.evaluate": {"seconds": 0.5,
                                               "cells": 30_000_000}}},
             {"stages": {"assembly.evaluate": {"seconds": 0.25,
                                               "cells": 30_000_000}}},
             {"stages": {"assembly.evaluate": {"seconds": 2.0,
                                               "cells": 30_000_000}}}]
    ctx = types.SimpleNamespace(units=units)
    assert reader().read(ctx) == pytest.approx(60_000_000.0)


def test_reads_nothing_without_the_count():
    parent = types.SimpleNamespace(units=[
        {"stages": {"assembly.evaluate": {"seconds": 7.0}}},
        {"stages": {"assembly.refine": {"seconds": 10.0}}}])
    assert reader().read(parent) is None
    assert reader().read(types.SimpleNamespace(units=[])) is None


def test_the_metric_names_both_assembly_cells():
    with open(ROOT / "BENCHMARK.json") as fh:
        bench = json.load(fh)
    m = next(m for m in bench["per_layer"] if m["name"] == NAME)
    assert m["workloads"] == ["ecoli.assembly", "ecoli.assembly_long_gaps"]
    assert m["moves"] == "assembly_gaps_per_s"
    assert m["layer"] == "Assembly stage"
