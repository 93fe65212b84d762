"""No module the harness or the reference imports has the top-level name
jax, jaxlib, flax or gappadder_tpu (compared whole: gappadder_tpu_torch
is the port), the reference and the traffic generators import nothing of
the port either, and run.py without a card exits non-zero and prints no
result."""

import ast
import os
import pathlib
import subprocess
import sys

import pytest

ROOT = pathlib.Path(__file__).resolve().parents[2]
PB = ROOT / "portbench"
NEVER = {"jax", "jaxlib", "flax", "gappadder_tpu"}
PORT = "gappadder_tpu_torch"


def top_level_imports(path: pathlib.Path) -> set:
    out = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            out |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            out.add(node.module.split(".")[0])
        elif isinstance(node, ast.Call) and getattr(
                node.func, "attr", "") == "import_module" and node.args and \
                isinstance(node.args[0], ast.Constant):
            out.add(node.args[0].value.split(".")[0])
    return out


def sources(*dirs):
    for d in dirs:
        for p in sorted((PB / d).rglob("*.py") if d else PB.glob("*.py")):
            yield p


@pytest.mark.parametrize("path", list(sources("", "harness", "entries",
                                              "metrics", "reference",
                                              "traffic")),
                         ids=lambda p: p.relative_to(ROOT).as_posix())
def test_no_source_imports_jax_or_the_jax_package(path):
    assert not top_level_imports(path) & NEVER


@pytest.mark.parametrize("path", list(sources("reference", "traffic")),
                         ids=lambda p: p.relative_to(ROOT).as_posix())
def test_reference_and_traffic_import_nothing_of_the_port(path):
    assert PORT not in top_level_imports(path)


def loaded_after(code: str) -> set:
    out = subprocess.run(
        [sys.executable, "-c", code + "\nimport sys\nprint(sorted({m.split('.')[0] "
         "for m in sys.modules}))"], cwd=ROOT, capture_output=True,
        text=True, check=True, env=dict(os.environ, PYTHONPATH=str(ROOT)))
    return set(eval(out.stdout.strip().splitlines()[-1]))


def test_loading_the_reference_loads_neither_jax_nor_the_port():
    mods = loaded_after(
        "import portbench.reference.recruit, portbench.reference.chain, "
        "portbench.reference.dbg, portbench.reference.sw, "
        "portbench.reference.step, portbench.traffic.genome_files, "
        "portbench.traffic.gap_batches")
    assert not mods & (NEVER | {PORT})


def test_loading_the_harness_and_entries_loads_no_jax():
    mods = loaded_after(
        "import portbench.harness.bench, portbench.harness.trace, "
        "portbench.harness.control, portbench.entries.cli_chain, "
        "portbench.entries.step, gappadder_tpu_torch.cli, "
        "gappadder_tpu_torch.parallel.slice")
    assert not mods & NEVER


def test_run_without_a_card_exits_nonzero_and_prints_no_result():
    import torch
    if torch.cuda.is_available():
        pytest.skip("this machine has a card")
    out = subprocess.run(
        [sys.executable, "portbench/run.py", "--workload", "chr14.step",
         "--seed", "3", "--seconds", "1", "--trace", "0"], cwd=ROOT,
        capture_output=True, text=True, timeout=300)
    assert out.returncode != 0
    assert out.stdout.strip() == ""
    assert "CUDA" in out.stderr


DRIVER = """
import io, sys
sys.path.insert(0, sys.argv[1])
from portbench.harness import bench
from portbench.tests.conftest import TINY
out = io.StringIO()
try:
    rc = bench.main(["--workload", "chr14.step", "--seed", "5", "--seconds",
                     "0", "--trace", "0"], device="cpu",
                    scale=TINY["chr14.step"], out=out)
except ImportError:
    rc = "ImportError"
print("RC", rc, repr(out.getvalue()))
"""


def test_a_checkout_without_the_program_exits_nonzero(tmp_path):
    """A directory with only BENCHMARK.json and portbench/: the program
    cannot be loaded, and no result is printed."""
    import shutil
    shutil.copytree(PB, tmp_path / "portbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path)
    out = subprocess.run([sys.executable, "-c", DRIVER, str(tmp_path)],
                         cwd=tmp_path, capture_output=True, text=True,
                         timeout=300, env={k: v for k, v in os.environ.items()
                                           if k != "PYTHONPATH"})
    assert "RC" in out.stdout and "RC 0 " not in out.stdout
    assert out.stdout.rstrip().endswith("''")
