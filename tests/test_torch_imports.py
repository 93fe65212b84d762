"""The port stands alone: no module of gappadder_tpu_torch, and not
chip_smoke.py, imports jax or anything of gappadder_tpu; and the entry
point never falls back to the CPU on its own."""

import ast
import pathlib

import numpy as np
import pytest
import torch

ROOT = pathlib.Path(__file__).resolve().parent.parent
PORT_FILES = sorted((ROOT / "gappadder_tpu_torch").rglob("*.py")) + \
    [ROOT / "chip_smoke.py"]


def _imported(path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                yield a.name
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module or ""


def _forbidden(name):
    top = name.split(".")[0]
    return top in ("jax", "jaxlib", "gappadder_tpu")


@pytest.mark.parametrize("path", PORT_FILES,
                         ids=[str(p.relative_to(ROOT)) for p in PORT_FILES])
def test_no_jax_or_reference_imports(path):
    bad = [n for n in _imported(path) if _forbidden(n)]
    assert not bad, f"{path.relative_to(ROOT)} imports {bad}"


def test_scan_catches_forbidden_names():
    assert _forbidden("jax.numpy")
    assert _forbidden("gappadder_tpu.ops.dbg")
    assert not _forbidden("gappadder_tpu_torch.ops.dbg")


def test_run_step_refuses_without_gpu(monkeypatch):
    from gappadder_tpu_torch.parallel import slice as sl
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    dims, args = sl.example_data(1, gaps_per_shard=1)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        sl.run_step(dims, args)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        sl.run_step(dims, args, device="cuda")
    # tensors already on the CPU do not make the default run there
    cpu_tensors = sl.inputs_from_numpy(args, "cpu")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        sl.run_step(dims, cpu_tensors)
    counts = sl.run_step(dims, args, device="cpu")[0]
    assert counts.device.type == "cpu" and counts.dtype == torch.int32
    assert np.asarray(counts)[0] == 25
    # mixed numpy and tensor inputs all go to the device asked for
    mixed = (cpu_tensors[0],) + tuple(args[1:])
    again = sl.run_step(dims, mixed, device="cpu")[0]
    assert torch.equal(again, counts)


def test_kernel_modules_import_without_cuda():
    """Importing the kernel modules builds nothing and needs no nvcc."""
    from gappadder_tpu_torch.ops import cuda_build, sw_cuda
    assert sw_cuda.launches >= 0
    assert cuda_build._loaded == {}
