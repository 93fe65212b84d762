"""A run with the timed path broken underneath comes out not correct,
once for each fault a cell can have: a unit that leaves its outputs
unchanged, half of the batch left out, and an answer altered where it
is produced. (No cell exchanges data between chips, so the fault of a
missing exchange has no cell here.)"""

import contextlib

import pytest

from portbench.tests.conftest import run_cell


@contextlib.contextmanager
def patched(module, name, make):
    inner = getattr(module, name)
    setattr(module, name, make(inner))
    try:
        yield
    finally:
        setattr(module, name, inner)


def stale(inner):
    """Each call returns the previous call's outputs."""
    last = []

    def step(*a, **kw):
        out = inner(*a, **kw)
        last.append(out)
        return last[-2] if len(last) > 1 else out
    return step


def half_left_out(inner):
    """The second half of the batch's gaps left out of the outputs."""
    def step(*a, **kw):
        out = [o.clone() for o in inner(*a, **kw)]
        h = out[4].shape[0] // 2
        out[3][h:] = 0
        out[4][h:] = -1
        out[7][h:] = 0
        for i in (9, 10, 11):
            out[i][h:] = 0
        return out
    return step


def base_altered(inner):
    """One base of the first gap's first contig changed."""
    def step(*a, **kw):
        out = [o.clone() for o in inner(*a, **kw)]
        out[6][0, 0, 5] = (out[6][0, 0, 5] + 1) % 4
        return out
    return step


@pytest.mark.parametrize("fault", [stale, half_left_out, base_altered])
def test_step_faults_come_out_not_correct(fault):
    from gappadder_tpu_torch.parallel import slice as sl
    with patched(sl, "run_step", fault):
        rc, res = run_cell("chr14.step", seed=4)
    assert rc == 0 and res["correct"] is False, res["checks"]
    assert res["failed"] >= 1


def cli_does_nothing(inner):
    def main(argv=None):
        return 0
    return main


def collect_half(inner):
    """Only the first half of a library's recruits."""
    def collect_library(*a, **kw):
        rec = inner(*a, **kw)
        n = len(rec["gap"]) // 2
        return {k: v[:n] for k, v in rec.items()}
    return collect_library


def collect_row_altered(inner):
    def collect_library(*a, **kw):
        rec = inner(*a, **kw)
        rec = {k: v.copy() for k, v in rec.items()}
        rec["row"][0] += 1
        return rec
    return collect_library


@pytest.mark.parametrize("where,fault", [
    ("cli", cli_does_nothing), ("collect", collect_half),
    ("collect", collect_row_altered)])
def test_collect_faults_come_out_not_correct(where, fault):
    from gappadder_tpu_torch import cli
    from gappadder_tpu_torch.pipeline import collect
    module, name = (cli, "main") if where == "cli" else \
        (collect, "collect_library")
    with patched(module, name, fault):
        rc, res = run_cell("ecoli.collect", seed=4)
    assert rc == 0 and res["correct"] is False, res["checks"]
