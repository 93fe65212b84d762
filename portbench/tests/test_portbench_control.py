"""Each cell's control at a size a test holds: the reference put in the
program's place with one of the configuration's guarantees broken,
written where the entry keeps a unit's outputs, comes out not correct by
the entry's own check, while the reference's own outputs pass it."""

import torch

from portbench.entries.step import step_params
from portbench.harness import control
from portbench.reference import step as ref
from portbench.tests.conftest import TINY

CPU = torch.device("cpu")


def test_the_collect_control_comes_out_not_correct():
    got = control.readings("ecoli.collect", 2**31 + 3, CPU,
                           TINY["ecoli.collect"])
    assert got["correct"] is False, got
    assert got["checks"]["recruits"][0] > 0
    assert got["checks"]["gap_reads"][0] > 0
    assert got["checks"]["both_unmapped"][0] == 0


def test_the_step_control_comes_out_not_correct():
    got = control.readings("chr14.step", 2**31 + 3, CPU, TINY["chr14.step"])
    assert got["correct"] is False, got
    assert got["checks"]["flank_scores"][0] > 0
    assert got["checks"]["read_tables"][0] == got["checks"]["unitigs"][0] == 0


def test_the_references_own_step_outputs_pass():
    ent = control.entry_for("chr14.step", 9, CPU, TINY["chr14.step"])
    control.step_control(ent)
    b, _out = ent.kept[0]
    args = ent.batches[b][1]
    dims = ent.ref_dims(b)
    params = step_params(ent.cfg)
    out, known = ref.reference_outputs(args, dims, params, CPU)
    stats = {}
    ref.lane_unitigs(args, known[0][0], dims, stats)
    assert ref.judge(args, out, dims, params, CPU, ref=known) == {
        "read_tables": 0, "unitigs": 0, "flank_scores": 0}
    # every gap recruits reads through all three classes; the graphs
    # branch, lose tips and fill the slots
    assert (out[3] > 0).all() and min(known[0][3]) > 0
    assert stats["tips"] > 0 and stats["branching"] > 0
    assert stats["eligible"] > out[8].size * dims["max_unitigs"]
