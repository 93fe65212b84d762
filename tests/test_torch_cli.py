"""The port's CLI against the JAX CLI on tests/test_cli.py's scenario:
`-c All --parity-files`, `-c All` again (every stage up to date) and
`-c Evaluate --finished`, each CLI on its own copy of the inputs at the
same path, so the config hash in the manifest is the same. Every
workspace file is equal byte for byte (the .npz files array by array),
but for the manifest's times and metrics.json; the printed lines are
equal too. Then the port's own flags: Clean, --trace, --coordinator's
refusal of a process id out of range, and the refusal to run without a
card unless asked for the CPU."""

import contextlib
import io
import json
import shutil

import numpy as np
import pytest
import torch

from gappadder_tpu import dna as jdna
from gappadder_tpu.cli import main as jax_main
from gappadder_tpu.io import fasta as jfasta
from gappadder_tpu_torch.cli import main as port_main
from gappadder_tpu_torch.config import config_from_dict
from gappadder_tpu_torch.testcases import (collect_scenario, config_dict,
                                           same_workspace)
from gappadder_tpu_torch.utils import meters

import read_simulator
from test_torch_run_scenarios import one_torch_thread  # noqa: F401


def write_inputs(root, rng):
    """tests/test_cli.py's scenario: one 140-bp gap in a 2 kb scaffold,
    420 read pairs. Returns the truth string."""
    L, gl, gs = 2000, 140, 900
    truth = "".join(np.array(list("ACGT"))[rng.integers(0, 4, L)])
    ge = gs + gl
    jfasta.write_fasta(root / "draft.fa",
                       [("scaf0", truth[:gs] + "N" * gl + truth[ge:])])
    read_simulator.write_library(root, "lib", truth, [(gs, ge)], 420, rng)
    jfasta.write_fasta(root / "finished.fa", [("t0", truth)])
    cfg = {
        "draft_genome": {"fa": "draft.fa"},
        "alignments": [{"bam": "lib.bam", "is": 300, "std": 30}],
        "raw_reads": [{"left": "lib_1.fastq", "right": "lib_2.fastq"}],
        "kmer_length": [{"k": 25, "k_velvet": [{"k": 21}]}],
        "parameters": {"working_folder": "work", "min_gap_size": 50,
                       "flank_length": 150, "nthreads": 1, "verbose": 0},
        "tpu": {"use_pallas": False, "read_batch": 4096},
    }
    (root / "work").mkdir()
    with open(root / "config.json", "w") as fh:
        json.dump(cfg, fh)
    return truth


def drive(main, root, extra=()):
    """-c All --parity-files, -c All, -c Evaluate; returns what each
    printed."""
    cfg = str(root / "config.json")
    out = []
    for argv in (["-c", "All", "-g", cfg, "--parity-files"],
                 ["-c", "All", "-g", cfg],
                 ["-c", "Evaluate", "-g", cfg, "--finished",
                  str(root / "finished.fa")]):
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            assert main(argv + list(extra)) == 0
        out.append(buf.getvalue())
    return out


@pytest.fixture(scope="module")
def both_clis(tmp_path_factory):
    """Both CLIs' workspaces and printed lines, run once: the JAX CLI on
    run/, moved to jax/, then the port's on a fresh run/, moved to
    port/."""
    base = tmp_path_factory.mktemp("cli")
    inputs = base / "inputs"
    inputs.mkdir()
    truth = write_inputs(inputs, np.random.default_rng(0))
    run = base / "run"
    outs = {}
    for tag, main, extra in (("jax", jax_main, ()),
                             ("port", port_main, ("--device", "cpu"))):
        shutil.copytree(inputs, run)
        outs[tag] = drive(main, run, extra)
        shutil.move(str(run), str(base / tag))
    return base, outs, truth


def test_cli_workspace_matches_jax(both_clis):
    base, _, truth = both_clis
    names = same_workspace(base / "jax" / "work", base / "port" / "work")
    for nm in ("gaps.npz", "recruits.npz", "both_unmapped.npz",
               "picked_seqs.fa", "picked_seqs.fa_ori.txt",
               "merge_info.txt", "filled_scaffolds.fa", "gap_positions.txt",
               "hit_list.txt", "closed_gap_length.txt", "manifest.json",
               "flank_regions/0_1.fa"):
        assert nm in names, nm
    assert (base / "jax/work/metrics.json").exists()
    assert any(n.startswith("merged/gap_reads/") for n in names)
    filled = dict(jfasta.iter_fasta(base / "port/work/filled_scaffolds.fa"))
    assert jdna.decode(filled["scaf0"]) == truth


def test_cli_prints_match_jax(both_clis):
    _, outs, _ = both_clis
    assert outs["port"] == outs["jax"]
    first, again, ev = outs["port"]
    assert "gaps closed" in first and "[patch] wrote" in first
    assert again.count("up-to-date") == 3
    assert "[evaluate] 1/1 picked fills close their gap" in ev


def test_cli_evaluate_hits_the_gap(both_clis):
    base, _, _ = both_clis
    work = base / "port" / "work"
    assert (work / "hit_list.txt").read_text().split() == ["0_1"]
    assert len((work / "closed_gap_length.txt").read_text().split()) == 1
    stats = json.load(open(work / "metrics.json"))
    assert {"preprocess", "collect", "assembly", "patch",
            "evaluate"} <= set(stats["stages"])


def test_cli_clean_removes_the_workspace(both_clis, tmp_path):
    base, _, _ = both_clis
    shutil.copytree(base / "port", tmp_path / "c")
    # the config names its workspace by a path relative to the config
    assert port_main(["-c", "Clean", "-g", str(tmp_path / "c/config.json"),
                      "--device", "cpu"]) == 0
    assert not (tmp_path / "c" / "work").exists()


def test_cli_trace_writes_a_trace(both_clis, tmp_path, capsys):
    base, _, _ = both_clis
    shutil.copytree(base / "port", tmp_path / "t")
    cfg = str(tmp_path / "t/config.json")
    assert port_main(["-c", "Patch", "-g", cfg, "--device", "cpu",
                      "--trace", str(tmp_path / "tr")]) == 0
    assert "[patch] wrote" in capsys.readouterr().out
    trace = json.load(open(tmp_path / "tr" / meters.TRACE_FILE))
    assert trace["traceEvents"]


def test_cli_refuses_coordinator(tmp_path, capsys):
    """--coordinator runs the CLI multi-process (tests/
    test_torch_multiprocess.py); a process id outside [0, N) is refused
    with exit code 2 before anything starts."""
    rc = port_main(["-c", "All", "-g", str(tmp_path / "none.json"),
                    "--coordinator", "localhost:1234", "--num-processes",
                    "2", "--process-id", "2", "--device", "cpu"])
    assert rc == 2
    assert "--process-id 2 is not in [0, --num-processes 2)" in \
        capsys.readouterr().err
    assert not (tmp_path / "work").exists()


def test_cli_refuses_without_gpu(monkeypatch, both_clis, tmp_path):
    base, _, _ = both_clis
    shutil.copytree(base / "port", tmp_path / "g")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = str(tmp_path / "g/config.json")
    for extra in ((), ("--device", "cuda")):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            port_main(["-c", "All", "-g", cfg, "--force", *extra])
    # nothing ran: the manifest is as the CPU run left it
    m = json.load(open(tmp_path / "g/work/manifest.json"))
    m0 = json.load(open(base / "port/work/manifest.json"))
    assert m == m0


def test_config_dict_loads_back(tmp_path):
    """The JSON config the card's CLI runs are given loads back into the
    same Config, field for field (and so the same config hash)."""
    cfg, _ = collect_scenario(str(tmp_path), 1, n_scaffolds=2,
                              scaffold_len=8000, gaps_per_scaffold=1,
                              libraries=((300, 50, 100, 5.0),), n_open=0)
    text = json.dumps(config_dict(cfg))
    assert config_from_dict(json.loads(text), base_dir="/elsewhere") == cfg
