"""The `ecoli.assembly` cell at a small size on the CPU: a run reads
`correct` true; a run with the program's picks broken underneath reads
each of the check's six numbers above its limit, and one whose CLI
writes nothing reads `correct` false; the control and the reference's
own picks; the traffic's fixed layout, with
`genome_files.write_scenario` unchanged; the extension rule; and the
cell's seven readers on a recorded context."""

import gzip
import hashlib
import io
import json
import os
import pathlib
import types

import numpy as np
import pytest
import torch

from portbench.harness import bench, control_assembly, trace
from portbench.reference import assembly as ref
from portbench.tests.conftest import TINY as SMALL
from portbench.tests.test_portbench_faults import cli_does_nothing, patched
from portbench.tests.test_portbench_metrics import record
from portbench.traffic import genome_files, layout_files

ROOT = pathlib.Path(__file__).resolve().parents[2]
CELL = "ecoli.assembly"
CPU = torch.device("cpu")
PARAMS = json.loads((ROOT / "portbench" / "configs" / "ecoli_k12.json")
                    .read_text())["parameters"]
# a size at which a unit takes seconds on the CPU: 4 gaps (1 open) in
# 60 kbp, one (k, sub_k), 100 bp flanks (the plain SW's time follows the
# flank length)
SCENARIO = {"n_scaffolds": 2, "scaffold_len": 30000, "gaps_per_scaffold": 2,
            "gap_len": [100, 300], "libraries": [[300, 50, 100, 30.0],
                                                 [10000, 500, 100, 5.0]],
            "n_open": 1, "mapq0": 0.02, "chimeric": 0.01}
TINY = {"config": {"scenario": SCENARIO, "kmers": [[30, 29]],
                   "parameters": dict(PARAMS, flank_length=100)}}


def run_cell(seed: int):
    out = io.StringIO()
    rc = bench.main(["--workload", CELL, "--seed", str(seed), "--seconds",
                     "0", "--trace", "0"], device="cpu", scale=TINY, out=out)
    text = out.getvalue().strip()
    return rc, (json.loads(text.splitlines()[-1]) if text else None)


def test_a_small_run_is_correct_and_reports_its_metrics():
    rc, res = run_cell(2**31 + 17)
    assert rc == 0 and res["correct"] is True, res and res["checks"]
    assert list(res["checks"]) == list(ref.NUMBERS) + ["units_unlike_last"]
    assert set(res["metrics"]) == {"assembly_gaps_per_s", "setup_s"}
    assert all(m["value"] > 0 for m in res["metrics"].values())
    assert res["attempted"] == 1 and res["failed"] == 0


def _first(fills, exts, open_gap: bool):
    """The first gap with a fill (or, `open_gap`, with an extension)."""
    return min(exts if open_gap else fills)


def base_altered(fills, exts, calls):
    g = _first(fills, exts, False)
    seq = np.array(fills[g][0])
    seq[len(seq) // 2] = (seq[len(seq) // 2] + 1) % 4
    fills[g] = (seq, fills[g][1])


def half_dropped(fills, exts, calls):
    """Half of the fills left out."""
    for g in sorted(fills)[::2]:
        del fills[g]


def open_gap_filled(fills, exts, calls):
    g = _first(fills, exts, True)
    fills[g] = (np.zeros(20, np.int8), "made_up")


def extension_base_off(fills, exts, calls):
    g = _first(fills, exts, True)
    seq = np.array(exts[g][0])
    i = 0 if seq[0] < 4 else len(seq) - 1
    seq[i] = (seq[i] + 1) % 4
    exts[g] = (seq,) + tuple(exts[g][1:])


def extensions_dropped(fills, exts, calls):
    """The final pick's extensions left out."""
    exts.clear()


def first_unit_altered(fills, exts, calls):
    if calls == 1:
        base_altered(fills, exts, calls)


@pytest.mark.parametrize("fault,number", [
    (base_altered, "fills_off"), (half_dropped, "closable_unfilled"),
    (open_gap_filled, "open_filled"),
    (extension_base_off, "extensions_off_truth"),
    (extensions_dropped, "extension_shortfall"),
    (first_unit_altered, "units_unlike_last")])
def test_a_planted_fault_reads_above_0(fault, number):
    from gappadder_tpu_torch.pipeline import run

    def make(inner):
        calls = []

        def write_picked(cfg, ws, gaps, fills, exts, contig_store=None):
            calls.append(1)
            fills, exts = dict(fills), dict(exts)
            fault(fills, exts, len(calls))
            return inner(cfg, ws, gaps, fills, exts, contig_store)
        return write_picked

    with patched(run, "_write_picked", make):
        rc, res = run_cell(2**31 + 23)
    assert rc == 0 and res["correct"] is False, res["checks"]
    assert res["checks"][number]["value"] > res["checks"][number]["limit"], \
        res["checks"]
    assert res["failed"] >= 1


def test_a_cli_that_writes_nothing_comes_out_not_correct():
    from gappadder_tpu_torch import cli
    with patched(cli, "main", cli_does_nothing):
        rc, res = run_cell(2**31 + 29)
    assert rc == 0 and res["correct"] is False, res["checks"]
    assert all(res["checks"][n]["value"] == ref.MISSING for n in ref.NUMBERS)


def test_the_control_comes_out_not_correct():
    got = control_assembly.readings(2**31 + 3, CPU, TINY)
    assert got["correct"] is False, got
    assert got["checks"]["open_filled"][0] == SCENARIO["n_open"]
    # no open gap extended: the shortfall is an open gap's whole reach
    short, limit = got["checks"]["extension_shortfall"]
    assert short > limit
    assert all(got["checks"][n][0] == 0 for n in got["checks"]
               if n not in ("open_filled", "extension_shortfall"))


def test_the_references_own_picks_pass():
    got = control_assembly.readings(2**31 + 3, CPU, TINY, fill_open=False)
    assert got["correct"] is True, got


# sha256 of write_scenario's files at ecoli.collect's small size, taken
# on the commit before layout_files.py was added (BAMs inflated: the
# deflated bytes follow the zlib build)
DIGESTS = {
    7: {"draft.fa": "d6e0e0c4d54334de28a502d8acc396e5b75481fb8027b229bc5aa8eda3051aa2",
        "lib0.bam": "6af0e9a011de89654431c57eb4184035b9b782c2d75db0e1c933414fc40bd584",
        "lib0_1.fastq": "1a03a9d1f83ebcea94188fe8e6c30083dc149983d5e2a53bfbebf8dfa9283729",
        "lib0_2.fastq": "c2cd17319f314cadf014c2940eb3365ddbe2ee3742f21aece1cc61e0198ecb97",
        "lib1.bam": "1e2f2f15bb8ea6e3dd6b682da92fe752e6c23fa6445865f4b44557a421f5b113",
        "lib1_1.fastq": "be5cdf64aa0e73e59d5c9ee1596eaf5573ec5fe7c68a3164ad51b2d448ed39e0",
        "lib1_2.fastq": "063b125d8bb984c4e5f847cc61f56b59a21b2fb1a740d94ec14dfb6b86783383"},
    2**31 + 11: {
        "draft.fa": "703815dd0ac7ff29b7590c4793b966b01d94284e15223b41383f153cc79e27ec",
        "lib0.bam": "6f5f265e083df319618523348e7aa3d44100d26575d72ca61a132c5d72440e3a",
        "lib0_1.fastq": "8c0aba7f6ee419ca4a35f2fc03c6fbd7d27e9494c58cddab97f257d12d97746a",
        "lib0_2.fastq": "f0188520f0410aad932c9418ff3494c64ac01ef37c1af926789fceb74271f89c",
        "lib1.bam": "c6a17b02eefc66ff9e1e89b7f6670a7aca3a5a0a708d05e595c417c4e568a2ca",
        "lib1_1.fastq": "b4021bf327fdd9e2e82da8adbb697f1ff93834c11399a4e713307ac3ca940737",
        "lib1_2.fastq": "35d3f8703b504db7db68137afd2da85cbe2741ce542c8eb359a7f0a22fc1875a"}}
COLLECT_SIZE = SMALL["ecoli.collect"]["config"]["scenario"]


def digests(root) -> dict:
    out = {}
    for name in sorted(os.listdir(root)):
        data = (root / name).read_bytes()
        if name.endswith(".bam"):
            data = gzip.decompress(data)
        out[name] = hashlib.sha256(data).hexdigest()
    return out


@pytest.mark.parametrize("seed", sorted(DIGESTS))
def test_write_scenario_draws_what_it_drew(tmp_path, seed):
    genome_files.write_scenario(tmp_path, seed, **COLLECT_SIZE)
    assert digests(tmp_path) == DIGESTS[seed]


# sha256 of the cell's files at SCENARIO (layout_seed 0) for two run
# seeds
LAYOUT_DIGESTS = {
    5: {"draft.fa": "9fa6cdd23205cf15bcc4c4c7088593344d9f932034fb93663e56eb8a1e838ef8",
        "lib0.bam": "0ca4191c0410759a7c042c2aa003d43d35da596690d243cc67aed8845bfc68ac",
        "lib0_1.fastq": "1b43a04ea36c651fc3212d02f18af9a0f9c81bd68e3e2b1e25cb6631db146d7f",
        "lib0_2.fastq": "b7fae7bf2fe93916f3913e1fccc231f6416d2af7629425cc110ad483dde04cc5",
        "lib1.bam": "5a8c02a982f3af35d6a63c757073337b39661c0ef0e77331061cd68e27830fbd",
        "lib1_1.fastq": "2be1d64f156dc424254fc1f93fa23432ae2631bf366852091b1e63046ae8b738",
        "lib1_2.fastq": "bcf8b4817ada02f90d6a08bdec337b0ae80d1cee2458ccd3aba06c5b8b3b008e"},
    2**31 + 5: {
        "draft.fa": "9fa6cdd23205cf15bcc4c4c7088593344d9f932034fb93663e56eb8a1e838ef8",
        "lib0.bam": "0ca4191c0410759a7c042c2aa003d43d35da596690d243cc67aed8845bfc68ac",
        "lib0_1.fastq": "fdb986045ae2ef21c8712c58ccca42d14e7751b7599979ac4d1001602efaf582",
        "lib0_2.fastq": "c7beef9d8b3bd1a4388e0c12f46e6b29d04b8a0f8c1239a9681845342a0d58cb",
        "lib1.bam": "5a8c02a982f3af35d6a63c757073337b39661c0ef0e77331061cd68e27830fbd",
        "lib1_1.fastq": "bdf1d60b57ed007bb5ce64030c0c5174a00458d1426d50bc6e6f6781f2efb152",
        "lib1_2.fastq": "d95faea899e5d53fd0bc639a7cee7623895b7c984405e3349a1f98a7db359c9e"}}


@pytest.mark.parametrize("seed", sorted(LAYOUT_DIGESTS))
def test_the_layout_files_draw_what_they_drew(tmp_path, seed):
    layout_files.write_scenario_layout(tmp_path, 0, seed, **SCENARIO)
    assert digests(tmp_path) == LAYOUT_DIGESTS[seed]


def _fastq_records(path) -> list:
    lines = path.read_bytes().splitlines()
    return [tuple(lines[i:i + 4]) for i in range(0, len(lines), 4)]


def test_the_layout_is_fixed_and_the_reads_follow_the_seed(tmp_path):
    """Every seed: write_scenario's draft, BAMs and reads for the
    layout seed; the seed draws the order of the FASTQs' pairs, and the
    returned rows follow the files."""
    a, b = (layout_files.write_scenario_layout(
        tmp_path / str(s), 0, s, **SCENARIO) for s in (5, 2**31 + 5))
    w = genome_files.write_scenario(tmp_path / "w", 0, **SCENARIO)
    da, db, dw = (digests(tmp_path / n) for n in ("5", str(2**31 + 5), "w"))
    for n in da:
        if n.endswith(".fastq"):
            assert da[n] != db[n] and da[n] != dw[n]
            got = [_fastq_records(tmp_path / d / n) for d in ("5", "w")]
            assert sorted(got[0]) == sorted(got[1]) and got[0] != got[1]
        else:
            assert da[n] == db[n] == dw[n]
    for la, lw in zip(a["libraries"], w["libraries"]):
        rows = _fastq_records(tmp_path / "5" / os.path.basename(la["left"]))
        assert [r[0][1:].split(b"/")[0] for r in rows] == \
            [bytes(x) for x in la["names"]]
        # each BAM record's pair is the FASTQ row of its read
        assert (la["names"][la["records"]["pair"]]
                == lw["names"][lw["records"]["pair"]]).all()
        assert (la["seq"][:, la["records"]["pair"]]
                == lw["seq"][:, lw["records"]["pair"]]).all()


def stages(batch, refine, evaluate, rescue, hq, pick):
    st = {"assembly.batch": batch, "assembly.refine": refine,
          "assembly.evaluate": evaluate, "assembly.rescue": rescue,
          "assembly.hq": hq, "assembly.pick": pick}
    return {k: {"seconds": v} for k, v in st.items() if v is not None}


def test_the_cells_readers_on_a_recorded_context():
    s = trace.reduce_events(record(), ("sort", "sw"))
    calls = [trace.Call("sort", [(100, 8), (100, 8)]),
             trace.Call("sw", ([300], [500]))]
    units = [{"wall_s": 9.0, "stages": stages(4.0, 2.0, 0.5, 0.3, 0.2, 1.0)},
             {"wall_s": 8.0, "stages": stages(3.0, 2.5, 0.5, 0.4, None, 1.5)},
             {"wall_s": 9.5, "stages": stages(5.0, 1.5, 0.5, 0.2, 0.1, 2.0)}]
    ctx = types.SimpleNamespace(trace=s, calls=calls, units=units, sms=132,
                                max_sm_clock_hz=1.98e9, traced_units=1)
    b = json.loads((ROOT / "BENCHMARK.json").read_text())
    names = [m["name"] for m in b["per_layer"]
             if m.get("workloads") == [CELL]]
    got = {n: bench.load_module(ROOT / "portbench" / "metrics" / f"{n}.py",
                                "m_" + n).read(ctx) for n in names}
    assert len(got) == 7 and all(isinstance(v, float) for v in got.values())
    assert got["idle_share.assembly"] == pytest.approx(61.0)
    # medians over the units; `assembly.evaluate` lies inside refine and
    # is not added; a span a unit did not open counts 0
    assert got["batch_s.assembly"] == 4.0
    assert got["refine_s.assembly"] == 2.0
    assert got["rescue_s.assembly"] == pytest.approx(0.4)
    assert got["pick_s.assembly"] == 1.5
    # without the program's spans, or a trace, nothing to read
    bare = types.SimpleNamespace(trace=None, calls=[], units=[{"wall_s": 1}])
    assert all(bench.load_module(ROOT / "portbench" / "metrics" / f"{n}.py",
                                 "m_" + n).read(bare) is None for n in names)


def _with_overlap(a: bytes, mismatches: int) -> bytes:
    """`a` with its first `mismatches` bases changed."""
    swap = bytes.maketrans(b"ACGT", b"CATG")
    return a[:mismatches].translate(swap) + a[mismatches:]


def _codes(a: bytes) -> np.ndarray:
    return np.frombuffer(a.translate(bytes.maketrans(b"ACGT", b"\0\1\2\3")),
                         np.int8)


def test_an_extension_side_is_anchored_truth_then_one_truth_piece():
    rng = np.random.default_rng(3)
    truth = [rng.integers(0, 4, 5000).astype(np.int8) for _ in range(2)]
    gap = {"scaffold": 0, "start": 2000, "end": 2300}
    t = [ref.ACGTN[x].tobytes() for x in truth]
    left, right = t[0][1995:2100], t[0][2200:2305]
    # a foreign contig whose first 12 bases overlap the left run's last
    # 12 with one mismatch (score 9 of 12 over the merger's 0.6 x 12),
    # on scaffold 1's reverse strand; one whose last 12 overlap the
    # right run's first 12 so, on scaffold 1's forward strand
    truth[1][900:912] = _codes(_with_overlap(left[-12:], 1).translate(
        ref.COMPLEMENT)[::-1])
    truth[1][772:784] = _codes(_with_overlap(right[:12], 1))
    t = [ref.ACGTN[x].tobytes() for x in truth]
    lpiece = t[1][840:900].translate(ref.COMPLEMENT)[::-1]
    rpiece = t[1][712:772]
    sc = {"scaffolds": truth}

    def ok(seq):
        return ref.extension_reach(sc, gap, 5, seq)[0]

    assert ok(left + b"NN" + right) and ok(b"NN" + right) and ok(left + b"NN")
    # the reverse-strand left pick keeps the flank's last base
    assert ok(t[0][1994:2100] + b"NN")
    assert not ok(t[0][1993:2100] + b"NN" + right)
    # a contig the merger joined: the rest of it, found in the truth
    # where its overlap aligns to the run
    assert ok(left + lpiece + b"NN" + rpiece + right)
    assert not ok(left + lpiece[:19] + b"NN" + right)
    assert not ok(left[:19] + lpiece + b"NN" + right)
    # a piece of the truth with no such overlap, or one the merger's
    # score refuses (two mismatches in 12)
    assert not ok(left + t[1][3000:3060] + b"NN" + right)
    assert not ok(left[:-12] + _with_overlap(left[-12:], 2) + lpiece
                  + b"NN" + right)
    assert not ok(left + b"N" + right) and not ok(left + b"NN" + b"N" + right)
    # any base changed is off, to a base that does not continue the
    # truth at the side's place either (which can make a longer run and
    # an overlap the merger takes)
    whole = left + lpiece + b"NN" + rpiece + right
    place = t[0][1995:1995 + len(left) + len(lpiece)] + b"NN" + \
        t[0][2200 - len(rpiece):2305]
    for i in range(len(whole)):
        if whole[i] != ord("N"):
            b = next(b for b in b"ACGT" if b not in (whole[i], place[i]))
            assert not ok(whole[:i] + bytes([b]) + whole[i + 1:]), i


def test_the_shortfall_is_the_nearer_sides_and_a_missing_one_its_reach():
    gap = {"start": 1000, "end": 1300}
    # reads reach up to 1125 on the left and from 1175 on the right; the
    # flanks end at 995 and start at 1305
    assert ref.shortfall(gap, 5) == 130
    assert ref.shortfall(gap, 5, 1120, None) == 5
    assert ref.shortfall(gap, 5, None, 1178) == 3
    assert ref.shortfall(gap, 5, 1125, 1175) == 0
    assert ref.shortfall(gap, 5, 1126, 1190) == 0
