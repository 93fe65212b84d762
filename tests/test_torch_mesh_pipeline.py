"""The port's whole pipeline with `tpu.mesh_shape` set (counterpart of
tests/test_mesh_pipeline.py): Preprocess, Collect and the Assembly
driver on the CPU with 8 CPU shards and mesh (4, 2) close the gap with
the planted bases, and write the unsharded run's recruits and
picked_seqs.fa byte for byte; a mesh of 2 with `tpu.fused` false,
which the port reads and ignores, writes them too."""

import dataclasses

import numpy as np
import pytest

from gappadder_tpu_torch import dna
from gappadder_tpu_torch.config import Config, Library, TpuParams
from gappadder_tpu_torch.io import fasta
from gappadder_tpu_torch.parallel import mesh as tmesh
from gappadder_tpu_torch.parallel import mp
from gappadder_tpu_torch.pipeline import collect, preprocess, run
from gappadder_tpu_torch.pipeline.workspace import Workspace

import read_simulator
from test_torch_run_scenarios import one_torch_thread  # noqa: F401


@pytest.fixture(scope="module")
def scenario(tmp_path_factory):
    """tests/test_mesh_pipeline.py's scenario: one 150-bp gap in a 2.4 kb
    scaffold, 500 read pairs; and its unsharded run's workspace."""
    root = tmp_path_factory.mktemp("mesh")
    rng = np.random.default_rng(0)
    L, gl = 2400, 150
    truth = "".join(np.array(list("ACGT"))[rng.integers(0, 4, L)])
    gs = L // 2
    ge = gs + gl
    draft = str(root / "draft.fa")
    fasta.write_fasta(draft, [("scaf0", truth[:gs] + "N" * gl + truth[ge:])])
    bam, lfq, rfq = read_simulator.write_library(
        root, "lib", truth, [(gs, ge)], 500, rng)
    cfg = Config(
        draft_genome=draft, min_gap_size=50, flank_length=150,
        working_folder=str(root / "unsharded"), kmers=((25, 21),),
        libraries=(Library(bam=bam, insert_size=300, std=30,
                           left_fq=lfq, right_fq=rfq),),
        tpu=TpuParams(read_batch=1 << 12, use_pallas=False,
                      mesh_shape=(4, 2), mesh_axes=("dp", "sp")))
    fills = _pipeline(cfg, cpu_devices=1)
    want = truth[gs - cfg.flank_margin:ge + cfg.flank_margin]
    return cfg, root, fills, want


def _pipeline(cfg, cpu_devices: int):
    """Preprocess, Collect and the driver on `cpu_devices` CPU shards;
    returns the fills."""
    old = mp.set_cpu_devices(cpu_devices)
    try:
        ws = Workspace(cfg.workdir)
        genome = fasta.read_fasta(cfg.draft_genome)
        preprocess.run_preprocess(cfg, ws, genome=genome, device="cpu")
        rec, readsets = collect.run_collect(cfg, ws, genome=genome,
                                            device="cpu")
        assert len(rec["gap"]) > 20
        fills, _exts, _ = run.run_assembly_and_pick(
            cfg, ws, rec=rec, readsets=readsets, genome=genome,
            device="cpu")
    finally:
        mp.set_cpu_devices(old)
    return fills


def _same_files(a, b):
    with np.load(f"{a}/recruits.npz") as za, np.load(f"{b}/recruits.npz") \
            as zb:
        assert sorted(za.files) == sorted(zb.files)
        for k in za.files:
            np.testing.assert_array_equal(za[k], zb[k], err_msg=k)
    for name in ("picked_seqs.fa", "picked_seqs.fa_ori.txt"):
        with open(f"{a}/{name}", "rb") as fa, open(f"{b}/{name}", "rb") as fb:
            assert fa.read() == fb.read(), name


def test_mesh_and_cpu_shards_are_counted(scenario):
    cfg, _root, _fills, _want = scenario
    old = mp.set_cpu_devices(8)
    try:
        mesh = tmesh.make_mesh_if_configured(cfg, "cpu")
        assert mesh.n_shards == 8 and mesh.shape == (4, 2)
        # fewer shards than the mesh asks for: unsharded (one local
        # shard), as JAX runs with no mesh
        mp.set_cpu_devices(7)
        assert tmesh.make_mesh_if_configured(cfg, "cpu") == \
            tmesh.local_mesh("cpu")
    finally:
        mp.set_cpu_devices(old)


def _spy(monkeypatch, name):
    """Record the shard count of every call of mesh.<name>."""
    seen = []
    inner = getattr(tmesh, name)

    def spy(mesh, *a, **kw):
        seen.append(mesh.n_shards)
        return inner(mesh, *a, **kw)
    monkeypatch.setattr(tmesh, name, spy)
    return seen


def test_pipeline_with_mesh(scenario, monkeypatch):
    cfg, root, base_fills, want = scenario
    cfg8 = dataclasses.replace(cfg, working_folder=str(root / "mesh42"))
    seen = _spy(monkeypatch, "_run_shards")
    fills = _pipeline(cfg8, cpu_devices=8)
    # Collect's pass-1 batches and the Assembly batches ran on 8 shards
    assert len(seen) >= 2 and set(seen) == {8}
    assert 0 in fills
    assert dna.decode(fills[0][0]) == want
    assert dna.decode(base_fills[0][0]) == want
    _same_files(cfg.workdir, cfg8.workdir)


def test_fused_false_pipeline_with_mesh(scenario, monkeypatch):
    """`"fused": false` in the config changes nothing: the one Assembly
    batch runs over the 2 shards and writes the unsharded run's files."""
    cfg, root, _fills, want = scenario
    cfg2 = dataclasses.replace(
        cfg, working_folder=str(root / "fused_false2"),
        tpu=dataclasses.replace(cfg.tpu, mesh_shape=(2,), mesh_axes=("dp",),
                                fused=False))
    seen = _spy(monkeypatch, "_run_shards")
    fills = _pipeline(cfg2, cpu_devices=2)
    # Collect's pass-1 batches and the Assembly batches ran on 2 shards
    assert len(seen) >= 2 and set(seen) == {2}
    assert dna.decode(fills[0][0]) == want
    _same_files(cfg.workdir, cfg2.workdir)
