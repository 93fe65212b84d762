"""The port's Preprocess and Patch (`ops/gapscan`, `pipeline/preprocess`,
`pipeline/patch`, `io/fasta.write_fai`) on the CPU against the JAX
package's, on the cases of tests/test_gapscan.py and
tests/test_preprocess.py and end-to-end-style fills: the device and
host forms of the scan and the flanks, scaffold edges, trailing
N-runs, the numbering per scaffold, and gaps.npz, gap_positions.txt,
the flank FASTAs, the .fai and filled_scaffolds.fa byte for byte."""

import os

import numpy as np
import pytest
import jax.numpy as jnp
import torch

from gappadder_tpu import dna as jdna
from gappadder_tpu.config import Config as JConfig
from gappadder_tpu.io import fasta as jfasta
from gappadder_tpu.ops import gapscan as jgapscan
from gappadder_tpu.pipeline import patch as jpatch
from gappadder_tpu.pipeline import preprocess as jpreprocess
from gappadder_tpu.pipeline.workspace import Workspace as JWorkspace
from gappadder_tpu_torch.io import fasta as tfasta
from gappadder_tpu_torch.ops import gapscan as tgapscan
from gappadder_tpu_torch.pipeline import patch as tpatch
from gappadder_tpu_torch.pipeline import preprocess as tpreprocess
from gappadder_tpu_torch.pipeline.workspace import Workspace

from test_torch_collect import assert_same_arrays
from test_torch_run_scenarios import port_config

DRAFTS = {
    "simple": ["ACGT" + "N" * 10 + "ACGT"],
    "min_gap_filter": ["ACGTNNNACGT" + "N" * 8 + "ACGT"],
    "trailing": ["ACGT" + "N" * 10],
    "across_scaffolds": ["ACGT" + "N" * 6, "N" * 6 + "ACGT"],
    "numbering": ["ACGTACGT" + "N" * 5 + "ACGT" + "N" * 7 + "ACGTACGT",
                  "TTTT" + "N" * 5 + "GGGG"],
    "edges": ["ACGTACG" + "N" * 8 + "TGCATGC", "N" * 9,
              "NNNNNACGT" + "N" * 5 + "ACGTNNNNN"],
    "ambiguity": ["ACGTNNRYNNNACGT" + "N" * 6 + "AC"],
}


def _genomes(tmp_path, seqs, name="g.fa"):
    path = str(tmp_path / name)
    jfasta.write_fasta(path, [(f"scaf{i}", s) for i, s in enumerate(seqs)])
    return jfasta.read_fasta(path), tfasta.read_fasta(path)


def _random_draft(rng, n=5):
    bases = np.array(list("ACGTN"))
    return ["".join(rng.choice(bases, size=int(rng.integers(50, 400))))
            for _ in range(n)]


@pytest.mark.parametrize("name", list(DRAFTS) + ["random"])
@pytest.mark.parametrize("min_gap", [1, 5])
def test_scan_genome_matches_jax(tmp_path, rng, name, min_gap):
    seqs = DRAFTS[name] if name != "random" else _random_draft(rng)
    jg, tg = _genomes(tmp_path, seqs)
    want = jgapscan.scan_genome_np(jg, min_gap_size=min_gap)
    got = tgapscan.scan_genome(tg, min_gap, device="cpu")
    assert_same_arrays(want, got, name)
    for cap in (0, 1, 2):
        assert_same_arrays(
            jgapscan.scan_genome_np(jg, min_gap, max_gaps=cap),
            tgapscan.scan_genome(tg, min_gap, max_gaps=cap, device="cpu"),
            f"{name} max_gaps={cap}")


def _planted(rng, L):
    seq = rng.integers(0, 4, L).astype(np.int8)
    for _ in range(int(rng.integers(1, 8))):
        a = int(rng.integers(0, L - 10))
        seq[a:a + int(rng.integers(1, 120))] = jdna.N
    for _ in range(2):
        seq[int(rng.integers(0, L))] = jdna.SEP
    seq[-int(rng.integers(1, 30)):] = jdna.N      # trailing run
    return seq


@pytest.mark.parametrize("trial", range(4))
def test_device_and_host_forms_match_jax(rng, trial):
    """find_gap_runs and extract_flanks (torch and numpy twins) against
    both JAX forms, with max_gaps cutting the runs too."""
    rng = np.random.default_rng(trial)
    L = int(rng.integers(500, 4000))
    seq = _planted(rng, L)
    hs, he = tgapscan.find_gap_runs_host(seq, 20)
    jhs, jhe = jgapscan.find_gap_runs_host(seq, 20)
    np.testing.assert_array_equal(hs, jhs)
    np.testing.assert_array_equal(he, jhe)
    for max_gaps in (64, 3, 1):
        want = jgapscan.find_gap_runs(jnp.asarray(seq), 20, max_gaps)
        got = tgapscan.find_gap_runs(torch.from_numpy(seq), 20, max_gaps)
        for w, g in zip(want, got):
            assert g.dtype == torch.int32
            np.testing.assert_array_equal(np.asarray(w), g.numpy())
    n = len(hs)
    sb = np.zeros(n, np.int64)
    se = np.full(n, L, np.int64)
    starts = np.concatenate([hs, [-1]])            # a padding gap too
    ends = np.concatenate([he, [-1]])
    sb, se = np.concatenate([sb, [0]]), np.concatenate([se, [0]])
    for flank, margin in ((100, 5), (7, 0)):
        want = jgapscan.extract_flanks(
            *(jnp.asarray(x, jnp.int32) for x in (seq, starts, ends, sb, se)),
            flank_len=flank, margin=margin)
        host = tgapscan.extract_flanks_host(seq, starts, ends, sb, se,
                                            flank_len=flank, margin=margin)
        dev = tgapscan.extract_flanks(
            *(torch.from_numpy(np.asarray(x)) for x in
              (seq, starts, ends, sb, se)), flank_len=flank, margin=margin)
        for w, h, d in zip(want, host, dev):
            w = np.asarray(w)
            assert w.dtype == h.dtype == d.numpy().dtype
            np.testing.assert_array_equal(w, h)
            np.testing.assert_array_equal(w, d.numpy())


def test_length_bucket_matches_jax():
    for n in (0, 1, 1024, 1025, 1536, 1537, 3000, 1 << 20, (1 << 20) + 1):
        assert tgapscan.length_bucket(n) == jgapscan.length_bucket(n)


def _draft(tmp_path):
    scaf0 = "ACGTACGTACGTACGTACGT" + "N" * 12 + "TGCATGCATGCATGCATGCA"
    scaf1 = "AAAACCCC" + "N" * 20 + "GGGGTTTT" + "N" * 6 + "CCAACCAA"
    scaf2 = "NNNGT" + "N" * 7 + "ACGTTGCA" + "N" * 9
    path = str(tmp_path / "draft.fa")
    jfasta.write_fasta(path, [("s0", scaf0), ("s1", scaf1), ("s2", scaf2)])
    return path


def _same_files(a, b, names):
    for nm in names:
        with open(os.path.join(a, nm), "rb") as fa, \
                open(os.path.join(b, nm), "rb") as fb:
            assert fa.read() == fb.read(), nm


@pytest.mark.parametrize("draft", ["gaps", "no_gaps"])
def test_run_preprocess_matches_jax(tmp_path, draft):
    if draft == "gaps":
        path = _draft(tmp_path)
    else:
        path = str(tmp_path / "draft.fa")
        jfasta.write_fasta(path, [("s0", "ACGT" * 10)])
    cfg = JConfig(draft_genome=path, min_gap_size=5, flank_length=15,
                  working_folder=str(tmp_path / "work"))
    jws = JWorkspace(cfg.workdir)
    want = jpreprocess.run_preprocess(cfg, jws, write_parity_files=True)
    tcfg = port_config(cfg, str(tmp_path / "port_work"))
    tws = Workspace(tcfg.workdir)
    got = tpreprocess.run_preprocess(tcfg, tws, write_parity_files=True,
                                     device="cpu")
    assert_same_arrays(want, got)
    assert_same_arrays(jws.load_arrays("gaps"), tws.load_arrays("gaps"))
    assert tws.load_json("scaffold_names") == jws.load_json("scaffold_names")
    _same_files(jws.root, tws.root, ["gap_positions.txt"])
    flanks = sorted(os.listdir(jws.path("flank_regions")))
    assert flanks == sorted(os.listdir(tws.path("flank_regions")))
    _same_files(jws.path("flank_regions"), tws.path("flank_regions"), flanks)
    assert tws.stage_info("preprocess")["num_gaps"] == len(want["start"])
    assert (len(flanks) == 4) == (draft == "gaps")


def test_write_fai_matches_jax(tmp_path):
    path = str(tmp_path / "g.fa")
    jfasta.write_fasta(path, [("s0 a comment", "ACGT" * 30), ("s1", "TT"),
                              ("s2", ""), ("s3", "N" * 161)], width=50)
    want = jfasta.write_fai(path, str(tmp_path / "j.fai"))
    got = tfasta.write_fai(path)
    assert got == path + ".fai"
    assert open(want, "rb").read() == open(got, "rb").read()


def _fills(rng, gaps):
    """End-to-end-style fills: the gap's bases with the flank margins
    around them, a few longer or shorter than the N-run, some gaps
    without a fill."""
    fills = {}
    for g in range(len(gaps["start"])):
        if g % 3 == 2:
            continue
        n = int(gaps["end"][g] - gaps["start"][g]) + 10 + (g % 2) * 3
        fills[g] = rng.integers(0, 4, n).astype(np.int8)
    return fills


def test_patch_scaffolds_matches_jax(tmp_path, rng):
    jg, tg = _genomes(tmp_path, ["ACGT" * 8 + "N" * 20 + "TTGA" * 9 +
                                 "N" * 7 + "GA" * 6, "CCA" + "N" * 9 + "TTT",
                                 "ACGT" * 5], "d.fa")
    gaps = jgapscan.scan_genome_np(jg, 5)
    fills = _fills(rng, gaps)
    for margin in (5, 0):
        want = jpatch.patch_scaffolds(jg, gaps, fills, margin=margin)
        got = tpatch.patch_scaffolds(tg, gaps, fills, margin=margin)
        assert [n for n, _ in want] == [n for n, _ in got]
        for (_, w), (_, g) in zip(want, got):
            np.testing.assert_array_equal(w, g)
        jfasta.write_fasta(str(tmp_path / "j.fa"), want)
        tfasta.write_fasta(str(tmp_path / "t.fa"), got)
        assert open(tmp_path / "j.fa", "rb").read() == \
            open(tmp_path / "t.fa", "rb").read()


def test_run_patch_matches_jax_cli_patch(tmp_path, rng):
    """run_patch reads the full closures of picked_seqs.fa (skipping
    extensions) and writes filled_scaffolds.fa as the JAX CLI's Patch
    step does."""
    from gappadder_tpu.cli import _fills_from_picked
    path = _draft(tmp_path)
    cfg = JConfig(draft_genome=path, min_gap_size=5, flank_length=15,
                  working_folder=str(tmp_path / "work"))
    jws = JWorkspace(cfg.workdir)
    gaps = jpreprocess.run_preprocess(cfg, jws)
    ids = jpreprocess.gap_ids(gaps)
    fills = _fills(rng, gaps)
    recs = [(f"{ids[g]}_a_b", f) for g, f in fills.items()]
    recs.insert(0, (f"{ids[2]}_x_extended", np.zeros(30, np.int8)))
    jfasta.write_fasta(jws.path("picked_seqs.fa"), recs)
    genome = jfasta.read_fasta(path)
    jrecs = jpatch.patch_scaffolds(genome, gaps, _fills_from_picked(jws, gaps),
                                   margin=cfg.flank_margin)
    jfasta.write_fasta(jws.path("filled_scaffolds.fa"), jrecs)
    tcfg = port_config(cfg, jws.root)
    got = tpatch.fills_from_picked(Workspace(tcfg.workdir), gaps)
    assert sorted(got) == sorted(fills) and 2 not in got
    os.rename(jws.path("filled_scaffolds.fa"), str(tmp_path / "jax.fa"))
    assert tpatch.run_patch(tcfg, Workspace(tcfg.workdir)) == len(fills)
    assert open(jws.path("filled_scaffolds.fa"), "rb").read() == \
        open(tmp_path / "jax.fa", "rb").read()


def test_preprocess_entry_points_refuse_without_gpu(tmp_path, monkeypatch):
    path = _draft(tmp_path)
    tcfg = port_config(JConfig(draft_genome=path, min_gap_size=5,
                               flank_length=15), str(tmp_path / "w"))
    genome = tfasta.read_fasta(path)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for call in (lambda **kw: tpreprocess.run_preprocess(tcfg, **kw),
                 lambda **kw: tgapscan.scan_genome(genome, 5, **kw)):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            call()
        with pytest.raises(RuntimeError, match="no CUDA device"):
            call(device="cuda")
        assert len(call(device="cpu")["start"]) == 4
