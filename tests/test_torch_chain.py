"""The port's whole chain on the CPU against the JAX package's:
Preprocess -> Collect -> run_assembly_and_pick -> Patch on one small
scenario (three gaps on 3 kb, reads from tests/read_simulator.py), every
file byte for byte and every .npz array by array; and the port's
Preprocess and Collect on a small `testcases.collect_scenario` (the
chip scenario's generator), where every classification branch is
live."""

import dataclasses
import os

import numpy as np
import pytest
import torch

from gappadder_tpu import dna as jdna
from gappadder_tpu.cli import _fills_from_picked
from gappadder_tpu.config import Config as JConfig
from gappadder_tpu.config import Library as JLibrary
from gappadder_tpu.config import TpuParams as JTpuParams
from gappadder_tpu.io import fasta as jfasta
from gappadder_tpu.pipeline import collect as jcollect
from gappadder_tpu.pipeline import patch as jpatch
from gappadder_tpu.pipeline import preprocess as jpreprocess
from gappadder_tpu.pipeline import run as jrun
from gappadder_tpu.pipeline.workspace import Workspace as JWorkspace
from gappadder_tpu_torch.parallel import mp
from gappadder_tpu_torch.pipeline import collect as tcollect
from gappadder_tpu_torch.pipeline import patch as tpatch
from gappadder_tpu_torch.pipeline import preprocess as tpreprocess
from gappadder_tpu_torch.pipeline import run as trun
from gappadder_tpu_torch.pipeline.workspace import Workspace, config_hash
from gappadder_tpu_torch.testcases import collect_scenario

import read_simulator
from test_torch_collect import assert_collect_equal, assert_same_arrays
from test_torch_run_scenarios import port_config

FILES = ("picked_seqs.fa", "picked_seqs.fa_ori.txt", "merge_info.txt",
         "filled_scaffolds.fa", "gap_positions.txt")
GAPS = ((600, 720), (1400, 1560), (2200, 2300))


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _scenario(tmp_path):
    rng = np.random.default_rng(11)
    truth = "".join(np.array(list("ACGT"))[rng.integers(0, 4, 3000)])
    draft = list(truth)
    for a, b in GAPS:
        draft[a:b] = "N" * (b - a)
    path = str(tmp_path / "draft.fa")
    jfasta.write_fasta(path, [("scaf0", "".join(draft))])
    bam, lfq, rfq = read_simulator.write_library(
        tmp_path, "lib", truth, list(GAPS), 700, rng, read_len=100,
        insert=300, std=30)
    cfg = JConfig(
        draft_genome=path, min_gap_size=50, flank_length=150,
        working_folder=str(tmp_path / "work"), kmers=((25, 21), (31, 27)),
        libraries=(JLibrary(bam=bam, insert_size=300, std=30, left_fq=lfq,
                            right_fq=rfq),),
        tpu=JTpuParams(read_batch=1 << 12, use_pallas=False))
    return cfg, truth


def test_chain_matches_jax(tmp_path):
    cfg, truth = _scenario(tmp_path)
    # the JAX chain, with the JAX CLI's Patch step
    jws = JWorkspace(cfg.workdir)
    genome = jfasta.read_fasta(cfg.draft_genome)
    gaps = jpreprocess.run_preprocess(cfg, jws, genome=genome,
                                      write_parity_files=True)
    jcollect.run_collect(cfg, jws, genome=genome, write_parity_files=True)
    jfills, _jexts, _ = jrun.run_assembly_and_pick(cfg, jws, genome=genome)
    jfasta.write_fasta(jws.path("filled_scaffolds.fa"), jpatch.patch_scaffolds(
        genome, gaps, _fills_from_picked(jws, gaps), margin=cfg.flank_margin))
    # the port's chain, every stage from the files
    tcfg = port_config(cfg, str(tmp_path / "port_work"))
    tws = Workspace(tcfg.workdir)
    tpreprocess.run_preprocess(tcfg, tws, write_parity_files=True,
                               device="cpu")
    tcollect.run_collect(tcfg, tws, write_parity_files=True, device="cpu")
    tfills, _texts, _ = trun.run_assembly_and_pick(tcfg, tws, device="cpu")
    assert tpatch.run_patch(tcfg, tws) == len(jfills)

    assert_collect_equal(jws, tws)
    for name in FILES:
        with open(jws.path(name), "rb") as a, open(tws.path(name), "rb") as b:
            assert a.read() == b.read(), name
    assert sorted(tfills) == sorted(jfills) == [0, 1, 2]
    filled = jdna.decode(jfasta.read_fasta(tws.path("filled_scaffolds.fa"))
                         .scaffold(0))
    assert filled == truth
    # each stage's manifest record: the hash of the same config is the
    # JAX package's
    same = port_config(cfg, cfg.working_folder)
    for stage in ("preprocess", "collect", "assembly"):
        assert tws.stage_info(stage)["config_hash"] == config_hash(tcfg)
        assert jws.stage_info(stage)["config_hash"] == config_hash(same)


def _count_branches(monkeypatch):
    """Counts of the clip, disc and unmap hits of pass 1 and the entries
    of pass 2, summed over the batches of a Collect run."""
    seen = {"clip": 0, "disc": 0, "unmap": 0, "pass2": 0}
    step = tcollect.make_extract_step
    low = tcollect._lowmapq_compact

    def make(dims, mesh, ecap=1 << 15):
        fn = step(dims, mesh, ecap)

        def counted(mat, *windows):
            packed, c3 = fn(mat, *windows)
            # each shard's three counts, summed over the shards
            for k, v in zip(("clip", "disc", "unmap"),
                            mp.to_np(c3).reshape(-1, 3).sum(0).tolist()):
                seen[k] += v
            return packed, c3
        return counted

    def low_counted(mat, windows, *, fanout, ecap):
        out = low(mat, windows, fanout=fanout, ecap=ecap)
        seen["pass2"] += int(out[0, 0])
        return out

    monkeypatch.setattr(tcollect, "make_extract_step", make)
    monkeypatch.setattr(tcollect, "_lowmapq_compact", low_counted)
    return seen


def _jax_config(tcfg, workdir):
    d = dataclasses.asdict(tcfg)
    return JConfig(**{**d, "working_folder": workdir,
                      "libraries": tuple(JLibrary(**x)
                                         for x in d["libraries"]),
                      "tpu": JTpuParams(**d["tpu"])})


def test_collect_scenario_matches_jax(tmp_path, monkeypatch):
    """The chip scenario's generator at a small size: 2 scaffolds of
    8 kb, 4 gaps (one open), a paired-end and a 2 kb mate-pair library.
    The port's Preprocess and Collect equal the JAX package's on its
    files, and every branch (clip, disc, unmap, pass 2, both-unmapped)
    has work."""
    tcfg, truth = collect_scenario(
        str(tmp_path / "scn"), 3, n_scaffolds=2, scaffold_len=8000,
        gaps_per_scaffold=2, libraries=((300, 50, 100, 30.0),
                                        (2000, 100, 100, 8.0)),
        n_open=1, mapq0=0.05, chimeric=0.03)
    assert truth["gaps"].shape == (4, 3) and len(truth["open"]) == 1
    cfg = _jax_config(tcfg, str(tmp_path / "jax_work"))
    jws = JWorkspace(cfg.workdir)
    jpreprocess.run_preprocess(cfg, jws, write_parity_files=True)
    jcollect.run_collect(cfg, jws, write_parity_files=True)
    seen = _count_branches(monkeypatch)
    tws = Workspace(tcfg.workdir)
    gaps = tpreprocess.run_preprocess(tcfg, tws, write_parity_files=True,
                                      device="cpu")
    tcollect.run_collect(tcfg, tws, write_parity_files=True, device="cpu")
    assert_collect_equal(jws, tws)
    assert_same_arrays(
        {"s": gaps["scaffold"], "a": gaps["local_start"],
         "b": gaps["local_end"]},
        {k: truth["gaps"][:, i].astype(np.int64)
         for i, k in enumerate("sab")})
    assert min(seen.values()) > 0, seen
    assert len(tws.load_arrays("both_unmapped")["row"]) > 0
    # no read covers the open gap's middle 50 bp
    g = truth["open"][0]
    s, a, b = truth["gaps"][g]
    mid = (a + b) // 2
    rows = tws.load_arrays("recruits")
    for li, lib in enumerate(tcfg.libraries):
        for side, path in ((0, lib.left_fq), (1, lib.right_fq)):
            rs = tcollect.read_fastq_any(path)
            sel = (rows["gap"] == g) & (rows["lib"] == li) & \
                (rows["side"] == side)
            ref = jdna.decode(truth["scaffolds"][s][mid - 25:mid + 25])
            for r in rows["row"][sel]:
                read = jdna.decode(rs.get_seq(int(r)))
                rc = jdna.decode(jdna.revcomp(rs.get_seq(int(r))))
                assert ref[:30] not in read and ref[:30] not in rc
    assert os.path.exists(tws.path("gap_positions.txt"))
