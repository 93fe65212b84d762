"""The port stands alone: no module of gappadder_tpu_torch, and not
chip_smoke.py, imports jax or anything of gappadder_tpu; and the entry
points never fall back to the CPU on their own."""

import ast
import pathlib

import numpy as np
import pytest
import torch

from test_torch_run_scenarios import one_torch_thread  # noqa: F401

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


def test_mesh_refuses_without_gpu(monkeypatch):
    """A mesh over this process's devices is the card's unless the
    caller names CPU devices; without a card it raises."""
    from gappadder_tpu_torch.parallel import mesh, mp
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        mesh.make_mesh()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        mp.local_devices("cuda")
    assert mesh.make_mesh((2,), ("dp",), ["cpu", "cpu"]).n_shards == 2
    assert mp.local_devices("cpu") == [torch.device("cpu")]


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
    from gappadder_tpu_torch import probes
    from gappadder_tpu_torch.ops import cuda_build, psort, sw_cuda
    assert sw_cuda.launches >= 0 and psort.launches >= 0
    assert min(probes.launches.values()) >= 0
    assert cuda_build._loaded == {}
    assert {p.stem for p in cuda_build.CSRC.glob("*.cu")} >= {"sw", "sort",
                                                              "probes"}


SLICE_MODULES = ["config", "utils.log", "io.fastq", "ops.swutil",
                 "pipeline.fused", "pipeline.pick", "pipeline.run",
                 "probes.__init__", "probes.kernel_experiments",
                 "probes.swprobe", "probes.int16_repro", "io.fasta",
                 "ops.evaluate_dp", "ops.merge_engine", "ops.seedmatch",
                 "parallel.mp", "pipeline.preprocess", "pipeline.rescue",
                 "pipeline.workspace", "testcases", "io.native", "io.bam",
                 "ops.minimap", "ops.gapscan", "pipeline.collect",
                 "pipeline.patch", "cli", "utils.meters", "ops.coverage",
                 "tools.__init__", "tools.evaluate", "tools.refiner",
                 "tools.scaffold", "parallel.mesh", "parallel.dist",
                 "parallel.slice", "parallel.mp_slice_worker"]


@pytest.mark.parametrize("mod", SLICE_MODULES)
def test_slice_modules_are_scanned_and_import(mod):
    import importlib
    path = ROOT / "gappadder_tpu_torch" / (mod.replace(".", "/") + ".py")
    assert path in PORT_FILES
    importlib.import_module("gappadder_tpu_torch." +
                            mod.removesuffix(".__init__"))


def _slice_inputs():
    from gappadder_tpu_torch.config import Config
    from gappadder_tpu_torch.parallel import slice as sl
    dims, args = sl.example_data(1, gaps_per_shard=1)
    rowtab = sl.run_step(dims, args, device="cpu")[4].numpy()
    readsets, per_gap, gaps = sl.example_reads(args, rowtab)
    return Config(draft_genome="d.fa", kmers=((17, 15),)), readsets, \
        per_gap, gaps, args[22].shape[1]


@pytest.mark.parametrize("entry", ["sw_pairs", "assemble_batch",
                                   "align_flanks_to_contigs"])
def test_slice_entry_points_refuse_without_gpu(monkeypatch, entry):
    from gappadder_tpu_torch.ops import swutil
    from gappadder_tpu_torch.ops.sw_host import BWA_PARAMS
    from gappadder_tpu_torch.pipeline import fused, pick
    cfg, readsets, per_gap, gaps, L = _slice_inputs()
    q = np.zeros((2, 8), np.int8)
    ln = np.full(2, 8, np.int32)
    contigs = fused.assemble_batch(cfg, [0], per_gap, readsets, 64, L, 1024,
                                   device="cpu")
    calls = {
        "sw_pairs": lambda **kw: swutil.sw_pairs(q, ln, q, ln, BWA_PARAMS,
                                                 "local", **kw),
        "assemble_batch": lambda **kw: fused.assemble_batch(
            cfg, [0], per_gap, readsets, 64, L, 1024, **kw),
        "align_flanks_to_contigs": lambda **kw: pick.align_flanks_to_contigs(
            gaps["flank_left"], gaps["flank_right"], contigs.seq,
            contigs.length, contigs.count, min_score=30, **kw),
    }
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        calls[entry]()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        calls[entry](device="cuda")
    assert calls[entry](device="cpu") is not None


def _probe_entries():
    from gappadder_tpu_torch.probes import int16_repro, kernel_experiments
    from gappadder_tpu_torch.probes import swprobe
    x = np.arange(32 * 8, dtype=np.int32).reshape(32, 8)
    return {
        "exp_dynamic_sublane": kernel_experiments.exp_dynamic_sublane,
        "exp_int16_loop": lambda **kw: kernel_experiments.exp_int16_loop(
            x, steps=5, **kw),
        "exp_int32_loop_with_argmax":
            lambda **kw: kernel_experiments.exp_int32_loop_with_argmax(
                x, steps=5, **kw)[0],
        "swprobe.run": lambda **kw: swprobe.run(x[:, :4], 2, nstep=16, **kw),
        "int16_repro.elementwise": int16_repro.elementwise,
        "int16_repro.roll": int16_repro.roll,
    }


PROBE_ENTRIES = ["exp_dynamic_sublane", "exp_int16_loop",
                 "exp_int32_loop_with_argmax", "swprobe.run",
                 "int16_repro.elementwise", "int16_repro.roll"]


@pytest.mark.parametrize("entry", PROBE_ENTRIES)
def test_probe_entry_points_refuse_without_gpu(monkeypatch, entry):
    """Each probe runs on the card unless asked for the CPU, and raises
    without a card; on the CPU it runs the plain twin and launches
    nothing."""
    from gappadder_tpu_torch import probes
    call = _probe_entries()[entry]
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        call()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        call(device="cuda")
    before = dict(probes.launches)
    out = call(device="cpu")
    assert out.device.type == "cpu" and out.numel() > 0
    assert probes.launches == before


@pytest.fixture(scope="module")
def driver_inputs(tmp_path_factory):
    """A one-gap toy workspace written without JAX, built once."""
    from gappadder_tpu_torch.config import Config
    from gappadder_tpu_torch.parallel import slice as sl
    from gappadder_tpu_torch.testcases import driver_workspace
    kset = ((17, 15),)
    dims, args = sl.example_data(1, gaps_per_shard=1, kset=kset)
    rowtab = sl.run_step(dims, args, device="cpu")[4].numpy()
    ws, rec, readsets, _, _ = driver_workspace(
        tmp_path_factory.mktemp("driver"), args, rowtab)
    return Config(draft_genome="d.fa", kmers=kset), ws, rec, readsets


def _driver_entries(cfg, ws, rec, readsets):
    """The driver's entry points on the toy workspace."""
    from gappadder_tpu_torch.ops import evaluate_dp, merge_engine
    from gappadder_tpu_torch.pipeline import rescue, run
    rng = np.random.default_rng(0)
    contigs = [rng.integers(0, 4, 90).astype(np.int8) for _ in range(2)]
    store = {0: run._tuple_from_list(contigs, ["a", "b"])}
    return {
        "run_assembly_and_pick": lambda **kw: run.run_assembly_and_pick(
            cfg, ws, rec, readsets, **kw),
        "eval_pairs_device": lambda **kw: evaluate_dp.eval_pairs_device(
            [tuple(contigs)], 50, **kw),
        "dedup_contigs_multi": lambda **kw: merge_engine.dedup_contigs_multi(
            [contigs], merge_engine.MergeConfig(), **kw),
        "rescue_both_unmapped": lambda **kw: rescue.rescue_both_unmapped(
            cfg, ws, readsets, store, [0], **kw),
        "hq_pseudo_contigs": lambda **kw: rescue.hq_pseudo_contigs(
            cfg, 0, store, readsets, [(0, 0, 0)], **kw),
    }


@pytest.mark.parametrize("entry", ["run_assembly_and_pick",
                                   "eval_pairs_device", "dedup_contigs_multi",
                                   "rescue_both_unmapped",
                                   "hq_pseudo_contigs"])
def test_driver_entry_points_refuse_without_gpu(monkeypatch, driver_inputs,
                                                entry):
    """The driver and its device stages run on the card unless asked for
    the CPU, and raise without a card; nothing falls back on its own."""
    call = _driver_entries(*driver_inputs)[entry]
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        call()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        call(device="cuda")
    assert call(device="cpu") is not None


def _tool_entries(tmp_path):
    """The CLI, Evaluate, the tools and the non-fused batch, each on a
    toy input."""
    import json
    from gappadder_tpu_torch import cli
    from gappadder_tpu_torch.config import Config
    from gappadder_tpu_torch.io import fasta
    from gappadder_tpu_torch.ops import swutil
    from gappadder_tpu_torch.ops.sw_host import BWA_PARAMS
    from gappadder_tpu_torch.pipeline import assemble
    from gappadder_tpu_torch.tools import evaluate, refiner, scaffold
    rng = np.random.default_rng(0)
    t = rng.integers(0, 4, 400).astype(np.int8)
    genome = fasta.Genome(seq=t, offsets=np.array([0]),
                          lengths=np.array([400]), names=["s"])
    fasta.write_fasta(tmp_path / "d.fa", [("s", t)])
    with open(tmp_path / "c.json", "w") as fh:
        json.dump({"draft_genome": {"fa": "d.fa"},
                   "parameters": {"working_folder": "w"}}, fh)
    reads = np.tile(t[None, None, :60], (1, 4, 1))
    rlen = np.full((1, 4), 60, np.int32)
    cfg = Config(draft_genome="d.fa", kmers=((17, 15),))
    gaps = {"start": np.array([200]), "end": np.array([220])}
    fl, fr = t[None, 100:195], t[None, 225:320]
    lens = (np.array([95]), np.array([95]))
    rec = {"gap": np.array([0]), "lib": np.array([0]), "side": np.array([0]),
           "row": np.array([0])}

    class Reads:
        length = np.array([60], np.int32)

        def get_seq(self, r):
            return t[:60]
    links = [(0, "a", 100, "+", 1, "b", 100, "+", 5, -20.0, -20.0, -20.0)]
    return {
        "cli.main": lambda **kw: cli.main(
            ["-c", "Preprocess", "-g", str(tmp_path / "c.json")]
            + (["--device", kw["device"]] if kw else [])),
        "sw_small": lambda **kw: swutil.sw_small([t[:30]], [t], BWA_PARAMS,
                                                 "local", **kw),
        "_best_placement": lambda **kw: evaluate._best_placement(
            t[50:90], genome, **kw),
        "seeded_placements": lambda **kw: evaluate.seeded_placements(
            [t[50:150]], genome, **kw),
        "extract_true_gap_seqs": lambda **kw: evaluate.extract_true_gap_seqs(
            gaps, genome, fl, fr, lens, **kw),
        "closure_stats": lambda **kw: evaluate.closure_stats(
            {0: t[190:230]}, {0: t[190:230]}, **kw),
        "discordant_alignment_stats":
            lambda **kw: evaluate.discordant_alignment_stats(
                rec, [(Reads(), None)], {0: t[:100]}, gaps, **kw),
        "classify_repeat": lambda **kw: refiner.classify_repeat(
            t[:50], t[:50], **kw),
        "build_scaffolds": lambda **kw: scaffold.build_scaffolds(
            [t[:100], t[80:180]], ["a", "b"], links, **kw),
        "gap_distinct_kmers": lambda **kw: assemble.gap_distinct_kmers(
            reads, rlen, np.array([4]), 17, 256, **kw),
        "count_gap_kmers": lambda **kw: assemble.count_gap_kmers(
            cfg, reads, rlen, np.array([4]), 17, 256, **kw),
        "assemble_gap_batch": lambda **kw: assemble.assemble_gap_batch(
            cfg, reads, rlen, np.array([4]), 256, **kw),
    }


TOOL_ENTRIES = ["cli.main", "sw_small", "_best_placement",
                "seeded_placements", "extract_true_gap_seqs", "closure_stats",
                "discordant_alignment_stats", "classify_repeat",
                "build_scaffolds", "gap_distinct_kmers", "count_gap_kmers",
                "assemble_gap_batch"]


@pytest.mark.parametrize("entry", TOOL_ENTRIES)
def test_cli_and_tool_entry_points_refuse_without_gpu(monkeypatch, tmp_path,
                                                      entry):
    """The CLI (no --device: the card), Evaluate, the tools and the
    non-fused batch run on the card unless asked for the CPU, and raise
    without a card; nothing falls back on its own."""
    call = _tool_entries(tmp_path)[entry]
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        call()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        call(device="cuda")
    assert call(device="cpu") is not None
