"""Port parity of the open-gap driver scenario as the port builds it
alone (`testcases.gap_scenario`, `open_gap_workspace`): the same files
as tests/test_end_to_end.py's scenario from the same seed, the same
Preprocess and Collect arrays as the JAX stages, and, with 0.1 % of the
read bases substituted, HQ pseudo-contigs built and every driver output
equal to the JAX package's."""

import numpy as np
import pytest

from gappadder_tpu_torch import testcases
from gappadder_tpu_torch.pipeline import rescue

from test_end_to_end import _setup
from test_torch_run_scenarios import (Calls, build, one_torch_thread,  # noqa: F401
                                      run_both_and_compare)

FILES = ("draft.fa", "lib.bam", "lib_1.fastq", "lib_2.fastq")


@pytest.mark.parametrize("err_rate", [0.0, testcases.OPEN_GAP_READ_ERRORS])
def test_port_scenario_writes_the_tests_files(tmp_path, err_rate):
    (tmp_path / "jax").mkdir()
    _setup(tmp_path / "jax", np.random.default_rng(0), err_rate=err_rate,
           **testcases.OPEN_GAP)
    testcases.gap_scenario(str(tmp_path / "port"), 0, err_rate=err_rate,
                           **testcases.OPEN_GAP)
    jax_files = sorted(p.name for p in (tmp_path / "jax").iterdir())
    assert jax_files == sorted(p.name for p in (tmp_path / "port").iterdir())
    assert set(FILES) <= set(jax_files)
    for name in jax_files:
        assert (tmp_path / "jax" / name).read_bytes() == \
            (tmp_path / "port" / name).read_bytes(), name


def test_port_open_gap_workspace_matches_jax(tmp_path):
    """The port's own Preprocess, Collect and cut of the both-unmapped
    pairs give the JAX-built workspace's arrays."""
    err = testcases.OPEN_GAP_READ_ERRORS
    (tmp_path / "jax").mkdir()
    cfg, _tcfg, _truth, _gap = build(tmp_path / "jax",
                                     np.random.default_rng(0), open_gap=True,
                                     err_rate=err, **testcases.OPEN_GAP)
    _c, ws, _t, _s, kept = testcases.open_gap_workspace(
        str(tmp_path / "port"), err_rate=err)
    assert kept > 0
    testcases.same_workspace(cfg.workdir, ws.root,
                             ("gaps.npz", "recruits.npz", "both_unmapped.npz"))


def test_open_gap_with_read_errors_builds_pseudo_contigs_as_jax(
        tmp_path, monkeypatch):
    cfg, tcfg, _truth, _gap = build(
        tmp_path, np.random.default_rng(0), open_gap=True,
        err_rate=testcases.OPEN_GAP_READ_ERRORS, **testcases.OPEN_GAP)
    hq = Calls(monkeypatch, rescue, "hq_pseudo_contigs")
    fills, exts, _ = run_both_and_compare(cfg, tcfg)
    assert len(hq.results) == 1 and len(hq.results[0]) >= 1
    assert fills == {} and list(exts) == [0] and len(exts[0][0]) > 0
