"""The `ecoli.assembly_long_gaps` cell at a small size on the CPU: a run
reads `correct` true and round 2 fills gaps round 1 could not, by the
unit's own counts; with rescue stubbed to recruit nothing the run reads
`correct` false on `closable_unfilled`; the cell's readers on a
recorded context; and the program's rescue recruits exactly what the
plain rule of `reference/rescue.py` recruits."""

import io
import json
import pathlib
import types

import numpy as np
import pytest

from portbench.harness import bench, trace
from portbench.reference import rescue as ref_rescue
from portbench.tests.test_portbench_faults import patched
from portbench.tests.test_portbench_metrics import record
from portbench.traffic import genome_files

ROOT = pathlib.Path(__file__).resolve().parents[2]
CELL = "ecoli.assembly_long_gaps"
PARAMS = json.loads((ROOT / "portbench" / "configs" /
                     "ecoli_k12_pe_long_gaps.json").read_text())["parameters"]
# 4 gaps of 500-650 bp (1 open) in 60 kbp, the one PE library, one
# (k, sub_k), 100 bp flanks: round 1 reaches ~280 bp from each side
SCENARIO = {"n_scaffolds": 2, "scaffold_len": 30000, "gaps_per_scaffold": 2,
            "gap_len": [500, 650], "libraries": [[300, 50, 100, 30.0]],
            "n_open": 1, "mapq0": 0.02, "chimeric": 0.01}
TINY = {"config": {"scenario": SCENARIO, "kmers": [[30, 29]],
                   "parameters": dict(PARAMS, flank_length=100)}}
ROUNDS = ("assembly.round1", "assembly.round2", "assembly.final")


def run_cell(seed: int, capsys):
    """One run at TINY on the CPU: (exit code, result line, the window
    units' spans as the run logs them)."""
    out = io.StringIO()
    rc = bench.main(["--workload", CELL, "--seed", str(seed), "--seconds",
                     "0", "--trace", "0"], device="cpu", scale=TINY, out=out)
    text = out.getvalue().strip()
    logged = [json.loads(x) for x in capsys.readouterr().err.splitlines()
              if x.startswith("{")]
    units = [x["stages"] for x in logged if "unit" in x and "stages" in x]
    return rc, (json.loads(text.splitlines()[-1]) if text else None), units


def test_a_small_run_is_correct_and_round_2_fills(capsys):
    rc, res, units = run_cell(2**31 + 41, capsys)
    assert rc == 0 and res["correct"] is True, res and res["checks"]
    assert set(res["metrics"]) == {"assembly_gaps_per_s", "setup_s"}
    closable = SCENARIO["n_scaffolds"] * SCENARIO["gaps_per_scaffold"] - \
        SCENARIO["n_open"]
    assert units
    for st in units:
        r1, r2, final = (st[n] for n in ROUNDS)
        assert r1["filled"] + r2["filled"] + final["filled"] == closable
        assert r2["gaps"] == r1["gaps"] - r1["filled"]
        assert r2["rescued"] >= 1 and r2["filled"] >= 1
        assert final["extended"] == SCENARIO["n_open"]
        rescue = st["assembly.rescue"]
        assert rescue["reads"] > 0 and rescue["recruited"] > 0


def test_without_rescue_the_run_is_not_correct(capsys):
    from gappadder_tpu_torch.pipeline import rescue
    with patched(rescue, "rescue_both_unmapped",
                 lambda inner: lambda *a, **kw: {}):
        rc, res, units = run_cell(2**31 + 43, capsys)
    assert rc == 0 and res["correct"] is False, res["checks"]
    off = res["checks"]["closable_unfilled"]
    assert off["value"] > off["limit"], res["checks"]
    assert all(st["assembly.round2"]["filled"] == 0 for st in units)


def stages(round2, final, rescue, reads):
    st = {"assembly.round2": {"seconds": round2},
          "assembly.final": {"seconds": final},
          "assembly.rescue": {"seconds": rescue}}
    if reads is not None:
        st["assembly.rescue"]["reads"] = reads
    st["assembly.batch"] = st["assembly.refine"] = st["assembly.pick"] = \
        {"seconds": 1.0}
    return st


def reader(name):
    return bench.load_module(ROOT / "portbench" / "metrics" / f"{name}.py",
                             "m_" + name)


def test_the_cells_readers_on_a_recorded_context():
    b = json.loads((ROOT / "BENCHMARK.json").read_text())
    names = [m["name"] for m in b["per_layer"]
             if CELL in m.get("workloads", [])]
    assert len(names) == 10
    s = trace.reduce_events(record(), ("sort", "sw"))
    calls = [trace.Call("sort", [(100, 8), (100, 8)]),
             trace.Call("sw", ([300], [500]))]
    units = [{"wall_s": 20.0, "stages": stages(8.0, 1.0, 0.5, 9000)},
             {"wall_s": 22.0, "stages": stages(9.0, 2.0, 0.6, 9000)},
             {"wall_s": 21.0, "stages": stages(7.0, 1.5, 0.4, 9000)}]
    ctx = types.SimpleNamespace(trace=s, calls=calls, units=units, sms=132,
                                max_sm_clock_hz=1.98e9, traced_units=1)
    got = {n: reader(n).read(ctx) for n in names}
    assert all(isinstance(v, float) for v in got.values()), got
    assert got["round2_s.long_gaps"] == 8.0
    assert got["final_s.long_gaps"] == 1.5
    assert got["rescue_reads_per_s.long_gaps"] == pytest.approx(18000.0)
    assert got["rescue_s.assembly"] == pytest.approx(0.5)
    # a program without the round spans or the rescue count (the parent
    # of the change that added them), or no trace: nothing to read
    parent = types.SimpleNamespace(units=[
        {"wall_s": 20.0, "stages": {"assembly.rescue": {"seconds": 0.5}}}])
    new = ("round2_s.long_gaps", "final_s.long_gaps",
           "rescue_reads_per_s.long_gaps")
    assert all(reader(n).read(parent) is None for n in new)
    bare = types.SimpleNamespace(trace=None, calls=[], units=[{"wall_s": 1}])
    assert all(reader(n).read(bare) is None for n in names)


def _revcomp(codes):
    return genome_files.COMPLEMENT[codes[::-1]]


def rescue_case(tmp_path, seed: int):
    """Seeded random truth with 3 gaps; each gap's round-1 contigs are
    truth pieces reaching into it from both sides (one on the reverse
    strand); the both-unmapped pairs lie inside the gaps, beside pairs
    of foreign sequence and of truth far from every contig. Returns the
    program's inputs and the reference's."""
    from gappadder_tpu_torch.config import Config
    from gappadder_tpu_torch.io import fastq
    from gappadder_tpu_torch.pipeline import run
    from gappadder_tpu_torch.pipeline.workspace import Workspace
    rng = np.random.default_rng(seed)
    rl = 100
    truth = rng.integers(0, 4, 30000).astype(np.int8)
    foreign = rng.integers(0, 4, 5000).astype(np.int8)
    store, starts = {}, []
    for g in range(3):
        a = 2000 + 8000 * g               # the gap's region [a, a + 1600)
        left = truth[a:a + 300 + int(rng.integers(0, 100))]
        right = truth[a + 1200 - int(rng.integers(0, 100)):a + 1600]
        contigs = [left, _revcomp(right)] if g != 1 else [left]
        store[g] = run._tuple_from_list(contigs, [f"c{i}"
                                                  for i in range(len(contigs))])
        starts.append(rng.integers(a + 150, a + 1350, 60))
    # pairs: inside the gaps, of foreign sequence, of truth far away
    src = [(truth, s) for s in np.concatenate(starts)]
    src += [(foreign, s) for s in rng.integers(0, 4500, 30)]
    src += [(truth, s) for s in rng.integers(26000, 29500, 30)]
    n = len(src)
    seq = np.zeros((2, n, rl), np.int8)
    for i, (base, a) in enumerate(src):
        ins = int(np.clip(rng.normal(300, 50), 2 * rl + 2, 450))
        a = min(int(a), len(base) - ins)
        seq[0, i] = base[a:a + rl]
        seq[1, i] = _revcomp(base[a + ins - rl:a + ins])
    digits = (np.arange(n)[:, None] // 10 ** np.arange(6)[::-1] % 10
              + ord("0")).astype(np.uint8)
    names = np.concatenate([np.broadcast_to(np.frombuffer(b"l0p_", np.uint8),
                                            (n, 4)), digits], axis=1)
    qual = np.full((n, rl), ord("I"), np.uint8)
    readsets = []
    for m in (1, 2):
        path = tmp_path / f"lib0_{m}.fastq"
        path.write_bytes(genome_files.fastq_bytes(names, seq[m - 1], qual, m))
        readsets.append(fastq.scan_fastq(str(path)))
    # both reads of every pair unmapped
    rows = np.arange(n, dtype=np.int32)
    bu = {"lib": np.zeros(2 * n, np.int32),
          "side": np.repeat(np.arange(2, dtype=np.int32), n),
          "row": np.concatenate([rows, rows])}
    ws = Workspace(str(tmp_path / "work"))
    ws.save_arrays("both_unmapped", **bu)
    cfg = Config(draft_genome=str(tmp_path / "d.fa"))
    gap_contigs = {g: [np.asarray(s[i][:int(ln[i])]) for i in range(c)]
                   for g, (s, ln, c, _nm) in store.items()}
    libraries = [{"seq": seq, "names": names}]
    entries = list(zip(bu["lib"], bu["side"], bu["row"]))
    return (cfg, ws, [tuple(readsets)], store), (libraries, entries,
                                                 gap_contigs)


@pytest.mark.parametrize("seed", [5, 2**31 + 7])
def test_rescue_recruits_what_the_plain_rule_recruits(tmp_path, seed):
    from gappadder_tpu_torch.pipeline import rescue
    (cfg, ws, readsets, store), (libs, entries, gap_contigs) = \
        rescue_case(tmp_path, seed)
    got = rescue.rescue_both_unmapped(cfg, ws, readsets, store, [0, 1, 2],
                                      device="cpu")
    want = ref_rescue.recruit_sets(libs, entries, gap_contigs)
    assert {g: set(v) for g, v in got.items()} == want
    # the case holds reads recruited, not recruited, and foreign ones
    assert all(want.get(g) for g in range(3))
    recruited = set().union(*want.values())
    assert 0 < len(recruited) < len(entries)


def test_a_gaps_target_scores_as_its_best_contig():
    """The separator makes the best score on a gap's joined contigs reach
    the limit exactly where the best on one contig does."""
    rng = np.random.default_rng(11)
    contigs = [rng.integers(0, 4, n).astype(np.int8) for n in (120, 90)]
    # reads across the junction of the two contigs: up to 29 bases of
    # each, and reads with 30 bases of one
    reads, lens = [], []
    for a, b in ((29, 29), (25, 29), (30, 10), (10, 30), (29, 40)):
        reads.append(np.concatenate([contigs[0][-a:], contigs[1][:b]]))
        lens.append(a + b)
    L = max(lens)
    arr = np.full((len(reads), L), ref_rescue.N_CODE, np.int8)
    for i, r in enumerate(reads):
        arr[i, :len(r)] = r
    lens = np.asarray(lens)
    joined = ref_rescue.best_scores(
        arr, lens, [ref_rescue.gap_target(contigs)])[:, 0]
    alone = ref_rescue.best_scores(arr, lens, contigs).max(axis=1)
    assert ((joined >= ref_rescue.MIN_SCORE) ==
            (alone >= ref_rescue.MIN_SCORE)).all()
    assert list(alone >= ref_rescue.MIN_SCORE) == [False, False, True, True,
                                                   True]
