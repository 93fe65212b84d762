"""The port across processes (counterpart of tests/test_multiprocess.py):
the CLI's `-c All` in N processes x M CPU shards through --coordinator
(gloo) writes the single-process CLI's files byte for byte; the
multi-process worker's step equals the single-process run on the same
mesh and the JAX step; a rank whose peers never join fails within its
timeout. Every rank runs under a timeout and all of them are killed
when one fails."""

import json
import os
import socket
import subprocess
import sys

import numpy as np
import pytest

from gappadder_tpu_torch.cli import main as port_main
from gappadder_tpu_torch.io import fasta
from gappadder_tpu_torch.parallel import mesh as tmesh
from gappadder_tpu_torch.parallel import mp
from gappadder_tpu_torch.parallel import slice as tsl
from gappadder_tpu_torch.parallel.mp_slice_worker import summarize

import read_simulator
from test_torch_run_scenarios import one_torch_thread  # noqa: F401

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FILES = ("picked_seqs.fa", "picked_seqs.fa_ori.txt", "filled_scaffolds.fa",
         "gap_positions.txt")


def free_port():
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def rank_env():
    env = {k: v for k, v in os.environ.items()
           if not k.startswith(("JAX_", "XLA_", "GAPPADDER_DIST_"))}
    env.update(PYTHONPATH=REPO, OMP_NUM_THREADS="1")
    return env


def run_ranks(cmds, timeout):
    """Start every rank, wait for all under one timeout; kill them all
    when one times out or fails. Returns each rank's output."""
    procs = [subprocess.Popen(c, env=rank_env(), stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT) for c in cmds]
    outs = []
    try:
        for p in procs:
            out, _ = p.communicate(timeout=timeout)
            outs.append(out.decode(errors="replace"))
            if p.returncode != 0:
                raise AssertionError(f"rank exited {p.returncode}:\n"
                                     f"{outs[-1][-4000:]}")
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    return outs


@pytest.mark.parametrize("n_procs,cpu_devices",
                         [(2, 2), pytest.param(4, 1, marks=pytest.mark.slow)])
def test_multi_process_cli_pipeline(tmp_path, n_procs, cpu_devices):
    """tests/test_multiprocess.py's scenario (6 kb, four 130-bp gaps,
    1400 pairs), mesh [4]: the N-process CLI's files equal the
    one-process CLI's (no mesh: one CPU shard) byte for byte."""
    rng = np.random.default_rng(0)
    L, gl = 6000, 130
    truth = "".join(np.array(list("ACGT"))[rng.integers(0, 4, L)])
    spans = [(s, s + gl) for s in (900, 2300, 3700, 5100)]
    draft = truth
    for s, e in spans:
        draft = draft[:s] + "N" * (e - s) + draft[e:]
    fasta.write_fasta(tmp_path / "draft.fa", [("scaf0", draft)])
    read_simulator.write_library(tmp_path, "lib", truth, spans, 1400, rng)

    def write_cfg(name, workdir):
        cfg = {
            "draft_genome": {"fa": "draft.fa"},
            "alignments": [{"bam": "lib.bam", "is": 300, "std": 30}],
            "raw_reads": [{"left": "lib_1.fastq", "right": "lib_2.fastq"}],
            "kmer_length": [{"k": 25, "k_velvet": [{"k": 21}]}],
            "parameters": {"working_folder": workdir, "min_gap_size": 50,
                           "flank_length": 150, "nthreads": 1,
                           "verbose": 0},
            "tpu": {"use_pallas": False, "read_batch": 4096,
                    "mesh_shape": [4], "gap_batch": 8},
        }
        with open(tmp_path / name, "w") as fh:
            json.dump(cfg, fh)
        return str(tmp_path / name)

    cfg_sp = write_cfg("config_sp.json", "work_sp")
    assert port_main(["-c", "All", "-g", cfg_sp, "--device", "cpu"]) == 0

    cfg_mp = write_cfg("config_mp.json", "work_mp")
    port = free_port()
    outs = run_ranks([
        [sys.executable, "-m", "gappadder_tpu_torch.cli", "-c", "All", "-g",
         cfg_mp, "--coordinator", f"127.0.0.1:{port}", "--num-processes",
         str(n_procs), "--process-id", str(pid), "--cpu-devices",
         str(cpu_devices), "--force"] for pid in range(n_procs)], 600)
    for pid, out in enumerate(outs):
        assert (f"[dist] process {pid}/{n_procs} backend gloo shards "
                f"{cpu_devices}") in out, out[-2000:]
    for fn in FILES:
        sp = (tmp_path / "work_sp" / fn).read_bytes()
        mp_ = (tmp_path / "work_mp" / fn).read_bytes()
        assert sp == mp_, fn
    assert (tmp_path / "work_mp" / "metrics.json").exists()
    filled = dict(fasta.iter_fasta(tmp_path / "work_mp" /
                                   "filled_scaffolds.fa"))
    from gappadder_tpu_torch import dna
    assert dna.decode(filled["scaf0"]) == truth


def test_two_process_slice_worker(tmp_path):
    """2 processes x 2 CPU shards of `mp_slice_worker` (one gap a shard)
    == the one-process 4-shard step == the JAX 4-shard step."""
    out_path = tmp_path / "mp_result.json"
    port = free_port()
    run_ranks([[sys.executable, "-m",
                "gappadder_tpu_torch.parallel.mp_slice_worker", str(pid), "2",
                "2", str(port), str(out_path), "--device", "cpu"]
               for pid in range(2)], 300)
    with open(out_path) as fh:
        got = json.load(fh)
    assert got["backend"] == "gloo" and got["n_shards"] == 4

    dims, args = tsl.example_data(4, gaps_per_shard=1)
    mesh = tmesh.make_mesh(shape=(4,), axes=("dp",), devices=["cpu"] * 4)
    out = tsl.make_slice_step(mesh, dims)(*tsl.place_args(mesh, args))
    one = summarize(dims, [mp.to_np(o) for o in out])
    for key in ("counts", "hist", "total_recv", "per_gap"):
        assert got[key] == one[key], key

    from test_slice import run_slice
    want = run_slice(4, 1)
    assert got["counts"] == want["counts"] and got["hist"] == want["hist"]
    assert got["total_recv"] == want["total_recv"]
    for g, w in want["per_gap"].items():
        assert got["per_gap"][str(g)] == dict(w, score=list(w["score"])), g


def test_rank_that_cannot_join_fails_within_its_timeout():
    """Rank 0 of 2 whose peer never comes exits non-zero after its
    3-second timeout, well inside the subprocess's own limit."""
    code = ("from gappadder_tpu_torch.parallel import mp; "
            f"mp.init_distributed('127.0.0.1:{free_port()}', 2, 0, "
            "local_cpu_devices=1, timeout_s=3)")
    p = subprocess.run([sys.executable, "-c", code], env=rank_env(),
                       capture_output=True, timeout=120)
    assert p.returncode != 0



def test_backend_rule():
    """gloo on CPU shards and where ranks share a card, else NCCL."""
    assert mp.backend_for(2, cards_shared=False) == "gloo"
    assert mp.backend_for(0, cards_shared=True) == "gloo"
    assert mp.backend_for(0, cards_shared=False) == "nccl"
