"""Runs of the harness at a small size on the CPU, in this process."""

import io
import json

import pytest

# sizes at which a run fits a test: a few gaps, one or two (k, sub_k)
TINY = {
    "chr14.step": {"config": {"batch": {
        "batches": 2, "gaps": 4, "gap_len": [100, 400], "read_len": 100,
        "coverage": 30.0, "errors": 0.003,
        "mapq": {"0-0": 0.02, "1-29": 0.03, "30-59": 0.05},
        "chimeric": 0.05, "foreign_len": 5000, "max_unitigs": 4},
        "kmers": [[30, 29], [40, 37]]}},
    "ecoli.collect": {"config": {"scenario": {
        "n_scaffolds": 2, "scaffold_len": 60000, "gaps_per_scaffold": 4,
        "gap_len": [100, 400], "libraries": [[300, 50, 100, 30.0],
                                             [10000, 500, 100, 5.0]],
        "n_open": 1, "mapq0": 0.02, "chimeric": 0.01}}},
}


@pytest.fixture(autouse=True)
def one_thread():
    import torch
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def run_cell(cell: str, seed: int = 7, seconds: float = 0, trace: int = 0):
    """One run of `cell` at its TINY size on the CPU: (exit code, the
    result line as a dict or None)."""
    from portbench.harness import bench
    out = io.StringIO()
    rc = bench.main(["--workload", cell, "--seed", str(seed),
                     "--seconds", str(seconds), "--trace", str(trace)],
                    device="cpu", scale=TINY[cell], out=out)
    text = out.getvalue().strip()
    return rc, (json.loads(text.splitlines()[-1]) if text else None)
