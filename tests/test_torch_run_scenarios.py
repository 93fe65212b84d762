"""Workspaces for holding the port's Assembly+Pick driver to the JAX
package's: the JAX Preprocess and Collect stages build the workspace on
the CPU (as tests/test_end_to_end.py does), then both packages'
`run_assembly_and_pick` run on copies of it and every output is
compared. Used by the other tests/test_torch_run_*.py files; it holds
no test itself."""

import dataclasses
import shutil

import numpy as np
import pytest
import torch

from gappadder_tpu import dna as jdna
from gappadder_tpu.io import fasta as jfasta
from gappadder_tpu.pipeline import collect, preprocess
from gappadder_tpu.pipeline import run as jrun
from gappadder_tpu.pipeline.workspace import Workspace as JWorkspace
from gappadder_tpu.pipeline.workspace import config_hash as jconfig_hash
from gappadder_tpu_torch import config as tconfig
from gappadder_tpu_torch.pipeline import run as trun
from gappadder_tpu_torch.pipeline.workspace import Workspace, config_hash

from test_end_to_end import _setup

OUTPUTS = ("picked_seqs.fa", "picked_seqs.fa_ori.txt", "merge_info.txt")


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """One intra-op thread: the plain DPs run thousands of small tensor
    steps, which a pool of threads does not speed up, and the pool's
    waiting threads slow the other test workers on the same cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def port_config(cfg, working_folder: str) -> tconfig.Config:
    """The JAX Config as the port's, field for field."""
    d = dataclasses.asdict(cfg)
    return tconfig.Config(**{
        **d, "working_folder": working_folder,
        "libraries": tuple(tconfig.Library(**x) for x in d["libraries"]),
        "tpu": tconfig.TpuParams(**d["tpu"])})


def keep_left_pairs(ws, readsets, truth: str, upto: int) -> int:
    """Keep in both_unmapped.npz only the pairs whose two reads both end
    at or before truth position `upto` (reads are placed by exact search
    on either strand). Returns the number of entries kept."""
    rc = jdna.decode(jdna.revcomp(jdna.encode(truth)))

    def end(li, side, row):
        r = jdna.decode(readsets[li][side].get_seq(row))
        p = truth.find(r)
        if p < 0:
            p = len(truth) - rc.find(r) - len(r)
        return p + len(r)

    bu = ws.load_arrays("both_unmapped")
    keep = np.array([max(end(li, 0, row), end(li, 1, row)) <= upto
                     for li, row in zip(bu["lib"], bu["row"])], bool)
    ws.save_arrays("both_unmapped", **{k: v[keep] for k, v in bu.items()})
    return int(keep.sum())


def build(tmp_path, rng, open_gap=False, **setup_kw):
    """JAX Preprocess + Collect into tmp_path/work, copied to
    tmp_path/port_work. Returns (jax cfg, port cfg, truth, (gs, ge))."""
    cfg, truth, (gs, ge) = _setup(tmp_path, rng, **setup_kw)
    ws = JWorkspace(cfg.workdir)
    genome = jfasta.read_fasta(cfg.draft_genome)
    preprocess.run_preprocess(cfg, ws, genome=genome)
    _rec, readsets = collect.run_collect(cfg, ws, genome=genome)
    if open_gap:
        assert keep_left_pairs(ws, readsets, truth, (gs + ge) // 2) > 0
    port_dir = str(tmp_path / "port_work")
    shutil.copytree(cfg.workdir, port_dir)
    return cfg, port_config(cfg, port_dir), truth, (gs, ge)


def _store(store):
    return {g: (s.tolist(), l.tolist(), int(n), list(nm))
            for g, (s, l, n, nm) in store.items()}


def run_both_and_compare(cfg, tcfg):
    """Both drivers from their workspaces' checkpoints (recruits.npz and
    the FASTQs, as `-c Assembly` starts); asserts every output equal.
    Returns the port's (fills, exts, contig_store)."""
    jws, tws = JWorkspace(cfg.workdir), Workspace(tcfg.workdir)
    jf, je, js = jrun.run_assembly_and_pick(cfg, jws)
    tf, te, ts = trun.run_assembly_and_pick(tcfg, tws, device="cpu")
    for name in OUTPUTS:
        with open(jws.path(name), "rb") as a, open(tws.path(name), "rb") as b:
            assert a.read() == b.read(), name
    assert {g: (s.tolist(), c) for g, (s, c) in jf.items()} == \
        {g: (s.tolist(), c) for g, (s, c) in tf.items()}
    assert {g: (e[0].tolist(),) + tuple(e[1:]) for g, e in je.items()} == \
        {g: (e[0].tolist(),) + tuple(e[1:]) for g, e in te.items()}
    assert _store(js) == _store(ts)
    # the manifest: same stage record, same hash of the same config
    assert tws.stage_info("assembly")["config_hash"] == config_hash(tcfg)
    assert config_hash(port_config(cfg, cfg.working_folder)) == \
        jconfig_hash(cfg) == jws.stage_info("assembly")["config_hash"]
    for k in ("filled", "extended"):
        assert tws.stage_info("assembly")[k] == \
            jws.stage_info("assembly")[k]
    return tf, te, ts


class Calls:
    """Wraps a module function, counting calls and keeping results."""

    def __init__(self, monkeypatch, module, name):
        self.results = []
        inner = getattr(module, name)

        def wrapped(*a, **kw):
            out = inner(*a, **kw)
            self.results.append(out)
            return out
        monkeypatch.setattr(module, name, wrapped)
