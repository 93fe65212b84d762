"""The port's spans and counters (`utils/meters.py`): the step's spans
nest as the layers do under `torch.profiler`, a step at six (k, sub_k)
enters few of them, a step with no profiler recording never opens a
profiler range, and each CLI call writes its own metrics.json, with
Collect's and the Assembly driver's parts beside the stages."""

import json
import os
import pathlib

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from gappadder_tpu_torch.cli import main as port_main
from gappadder_tpu_torch.parallel import slice as sl
from gappadder_tpu_torch.testcases import collect_scenario, config_dict
from gappadder_tpu_torch.utils import meters


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """One intra-op thread, as the other port test modules pin: the
    steps here are many small tensor operations."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)

# the six (k, sub_k) of GAPPadder's configuration.json
SIX = ((30, 29), (30, 27), (40, 39), (40, 37), (50, 49), (50, 47))


def profiled_spans(fn):
    """[(start, end, name)] of the program spans `fn` opened under a CPU
    profiler, sorted by start (the outer span first on a tie)."""
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        fn()
    out = []
    for e in prof.profiler.kineto_results.events():
        if e.name().startswith(meters.PREFIX):
            s = e.start_ns()
            out.append((s, s + e.duration_ns(),
                        e.name()[len(meters.PREFIX):]))
    return sorted(out, key=lambda x: (x[0], -x[1]))


def parents(spans):
    """{name: set of names of the spans directly around it}."""
    out, stack = {}, []
    for s, e, name in spans:
        while stack and stack[-1][1] <= s:
            stack.pop()
        out.setdefault(name, set()).add(stack[-1][2] if stack else None)
        stack.append((s, e, name))
    return out


@pytest.fixture(scope="module")
def six_settings():
    dims, args = sl.example_data(1, gaps_per_shard=2, read_len=64,
                                 kset=SIX)
    return dims, args


def test_step_spans_nest_as_the_layers(six_settings):
    dims, args = six_settings
    spans = profiled_spans(lambda: sl.run_step(dims, args, device="cpu"))
    up = parents(spans)
    for block in ("step.block1", "step.block2", "step.gather",
                  "step.block3", "step.block4"):
        assert up[block] == {None}, block
    assert up["kmers.distinct"] == {"step.block3"}
    assert up["kmers.unpack"] == {"kmers.distinct"}
    assert up["dbg.unitigs"] == {"step.block3"}
    for part in ("dbg.prep", "dbg.graph", "dbg.chains", "dbg.emit"):
        assert up[part] == {"dbg.unitigs"}, part
    names = [n for _s, _e, n in spans]
    # one distinct-k-mer merge a unique k; one batched DBG a step, one
    # graph build an occurrence-row group ((k, k - 1) and (k, k - 3))
    assert names.count("kmers.distinct") == 3
    assert names.count("dbg.unitigs") == 1
    assert names.count("dbg.graph") == 2
    # a step enters few spans: their cost off is a few microseconds
    assert len(spans) <= 64


def test_step_meters_count_the_dbg_settings_groups_and_lanes(six_settings):
    dims, args = six_settings
    with meters.Meters() as m:
        sl.run_step(dims, args, device="cpu")
    rec = m.stages["dbg.unitigs"]
    assert (rec["settings"], rec["groups"], rec["lanes"]) == \
        (6, 2, 6 * dims.gaps_per_shard)


def test_step_opens_no_range_without_a_profiler(six_settings, monkeypatch):
    dims, args = six_settings
    want = sl.run_step(dims, args, device="cpu")

    def refuse(*a, **kw):
        raise AssertionError("a span opened a profiler range")

    monkeypatch.setattr(torch.profiler, "record_function", refuse)
    got = sl.run_step(dims, args, device="cpu")
    for a, b in zip(want, got):
        assert torch.equal(a, b)


def test_a_span_off_is_one_shared_object():
    assert meters._current is None
    assert meters.span("a") is meters.span("b")
    with meters.span("a") as s:
        s.add(n=1)
        s.set(v=2)


def test_meters_add_seconds_and_counts_by_span_name():
    with meters.Meters() as outer:
        with meters.Meters() as m:
            for n in (3, 4):
                with meters.span("part") as s:
                    s.add(items=n)
            with meters.span("level") as s:
                s.set(bytes=5)
                s.set(bytes=7)
            meters.memory(s, "cpu")       # nothing to record on the CPU
        assert meters._current is outer
    assert meters._current is None
    assert m.stages["part"]["items"] == 7
    assert m.stages["part"]["seconds"] >= 0
    assert m.stages["level"] == {"seconds": m.stages["level"]["seconds"],
                                 "bytes": 7}
    assert outer.stages == {}


def test_record_function_only_in_meters():
    root = pathlib.Path(meters.__file__).resolve().parents[1]
    users = sorted(str(p.relative_to(root)) for p in root.rglob("*.py")
                   if "record_function" in p.read_text())
    assert users == [os.path.join("utils", "meters.py")]


@pytest.fixture(scope="module")
def collect_workspace(tmp_path_factory):
    """A small scenario's config after one Preprocess through the CLI."""
    root = tmp_path_factory.mktemp("spans")
    cfg, _ = collect_scenario(str(root), 3, n_scaffolds=2,
                              scaffold_len=12000, gaps_per_scaffold=2,
                              libraries=((300, 50, 100, 8.0),), n_open=0)
    path = str(root / "config.json")
    with open(path, "w") as fh:
        json.dump(config_dict(cfg), fh)
    assert port_main(["-c", "Preprocess", "-g", path, "--device",
                      "cpu"]) == 0
    return cfg, path


def test_metrics_json_holds_one_call(collect_workspace, capsys):
    cfg, path = collect_workspace
    argv = ["-c", "Collect", "-g", path, "--force", "--parity-files",
            "--device", "cpu"]
    stats = []
    for _ in range(2):
        assert port_main(argv) == 0
        with open(os.path.join(cfg.workdir, "metrics.json")) as fh:
            stats.append(json.load(fh))
    capsys.readouterr()
    first, second = (s["stages"] for s in stats)
    # counts are the call's own, not two calls' sums
    assert first["collect.bam_decode"]["records"] > 0
    for name in ("collect", "collect.bam_decode", "collect.fastq_scan",
                 "collect.pass1", "collect.gap_fastqs"):
        assert {k: v for k, v in second[name].items() if k != "seconds"} \
            == {k: v for k, v in first[name].items() if k != "seconds"}, name
    assert "preprocess" not in second
    assert second["collect.gap_fastqs"]["files"] > 0
    assert second["collect.gap_fastqs"]["bytes"] > 0
    for name in ("cli.read_draft", "collect.windows", "collect.union",
                 "collect.both_unmapped", "collect.save"):
        assert name in second, name
    # the parts lie inside the call
    parts = sum(second[n]["seconds"] for n in second
                if n.startswith("collect."))
    assert parts <= second["collect"]["seconds"] <= \
        stats[1]["total_seconds"]
    assert meters._current is None


def test_assembly_driver_spans(tmp_path):
    """The Assembly driver's parts, on the toy scenario with every gap's
    inside reads held back for rescue, and block 3's parts under its
    batches."""
    from gappadder_tpu_torch.config import Config
    from gappadder_tpu_torch.pipeline import run
    from gappadder_tpu_torch.testcases import driver_workspace
    kset = ((17, 15), (21, 19))
    dims, args = sl.example_data(1, gaps_per_shard=3, kset=kset,
                                 gap_len=(84, 100), seed=1)
    rowtab = sl.run_step(dims, args, device="cpu")[4].numpy()
    ws, rec, readsets, _, _ = driver_workspace(tmp_path, args, rowtab,
                                               (0, 1, 2))
    cfg = Config(draft_genome="d.fa", kmers=kset)
    with meters.Meters() as m:
        fills, _, _ = run.run_assembly_and_pick(cfg, ws, rec, readsets,
                                                device="cpu")
    st = m.stages
    assert fills
    # round 1 and round 2, each at least one batch of real gaps
    assert st["assembly.batch"]["batches"] >= 2
    assert st["assembly.batch"]["gaps"] >= 6
    for name in ("assembly.refine", "assembly.pick", "assembly.rescue",
                 "kmers.distinct", "kmers.unpack", "dbg.unitigs",
                 "dbg.prep", "dbg.graph", "dbg.chains", "dbg.emit"):
        assert st[name]["seconds"] > 0, name
    # the three rounds: the gaps each works on, the fills each adds
    r1, r2, final = (st[f"assembly.{r}"] for r in ("round1", "round2",
                                                   "final"))
    assert r1["gaps"] == 3
    assert r2["gaps"] == r1["gaps"] - r1["filled"]
    assert final["gaps"] == r2["gaps"] - r2["filled"]
    assert r1["filled"] + r2["filled"] + final["filled"] == len(fills)
    # rescue closes what round 1 could not
    assert r2["rescued"] >= 1 and r2["filled"] >= 1
    assert final["hq_gaps"] <= final["gaps"]
    assert final["extended"] <= final["gaps"]
    assert st["assembly.rescue"]["reads"] > 0
    assert st["assembly.rescue"]["recruited"] > 0
    assert st["assembly.rescue"]["verified"] <= \
        st["assembly.rescue"]["candidates"]


def test_pick_span_counts_the_host_tracebacks(monkeypatch):
    """`assembly.pick` counts each pass's winners (`tracebacks`), their
    cells (the sum of qend * tend) and the traceback kernel's `launches`:
    on the CPU exactly the winners the host traceback traced, and no
    launch."""
    from gappadder_tpu_torch.config import Config
    from gappadder_tpu_torch.ops import sw_host
    from gappadder_tpu_torch.pipeline import run
    traced = []
    host = sw_host.alignment_stats_batch

    def counted(q, ql, t, tl, p, mode, qend, tend):
        traced.append((len(qend),
                       int((np.asarray(qend, np.int64) * tend).sum())))
        return host(q, ql, t, tl, p, mode, qend, tend)
    monkeypatch.setattr(sw_host, "alignment_stats_batch", counted)
    # two gaps, three contigs each: the first spans both flanks and the
    # gap, the second holds two copies of the left flank with its last
    # base changed (a second local pass; a fit pass), the third neither
    rng = np.random.default_rng(3)
    FL, L = 120, 400
    store, fl, fr = {}, [], []
    for g in range(2):
        contigs = [rng.integers(0, 4, L).astype(np.int8) for _ in range(3)]
        for at in (20, 250):
            contigs[1][at:at + FL] = contigs[0][50:50 + FL]
            contigs[1][at + FL - 1] = (contigs[0][50 + FL - 1] + 1) % 4
        store[g] = run._tuple_from_list(contigs, [f"c{g}_{i}"
                                                  for i in range(3)])
        fl.append(np.append(contigs[0][50:50 + FL], 4))
        fr.append(np.append(contigs[0][300:300 + FL], 4))
    gaps = {"flank_left": np.array(fl), "flank_right": np.array(fr)}
    fills, exts = {}, {}
    with meters.Meters() as m:
        run._pick_gaps(Config(draft_genome="d.fa"), gaps, [0, 1], store,
                       fills, exts, 30, True, device="cpu")
    assert sorted(fills) == [0, 1]
    rec = m.stages["assembly.pick"]
    assert len(traced) == 3              # two local passes, the fit pass
    assert rec["tracebacks"] == sum(n for n, _ in traced) > 0
    assert rec["cells"] == sum(c for _, c in traced)
    assert rec["launches"] == 0
