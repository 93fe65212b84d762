"""The port's Collect stage (`gappadder_tpu_torch.pipeline.collect`) on
the CPU against the JAX package's, on the cases of tests/test_collect.py:
800 random alignment records over every classification branch, three
scaffolds, three gaps. Both packages' Preprocess and Collect run on the
same draft, BAM and FASTQs; recruits.npz, both_unmapped.npz and every
per-gap FASTQ must be equal, array by array and byte for byte."""

import dataclasses
import os

import numpy as np
import pytest
import torch

from gappadder_tpu.pipeline import collect as jcollect
from gappadder_tpu_torch.io import fastq as tfastq
from gappadder_tpu_torch.io import native as tnative
from gappadder_tpu_torch.pipeline import collect as tcollect
from gappadder_tpu_torch.pipeline import preprocess as tpreprocess
from gappadder_tpu_torch.pipeline.workspace import Workspace

from test_collect import _gen_records, _pipeline_run
from test_torch_run_scenarios import port_config

PARITY_DIRS = ("merged/gap_reads", "merged/gap_reads_high_quality")


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def assert_same_arrays(a: dict, b: dict, what=""):
    assert sorted(a) == sorted(b), what
    for k in a:
        assert a[k].dtype == b[k].dtype, (what, k, a[k].dtype, b[k].dtype)
        assert a[k].shape == b[k].shape, (what, k)
        np.testing.assert_array_equal(a[k], b[k], err_msg=f"{what} {k}")


def assert_same_tree(root_a, root_b, sub):
    da, db = os.path.join(root_a, sub), os.path.join(root_b, sub)
    names = sorted(os.listdir(da))
    assert names == sorted(os.listdir(db)), sub
    assert names, f"{sub} is empty"
    for nm in names:
        with open(os.path.join(da, nm), "rb") as fa, \
                open(os.path.join(db, nm), "rb") as fb:
            assert fa.read() == fb.read(), (sub, nm)


def jax_and_port(tmp_path, insert_size, std, **port_kw):
    """Both packages' Preprocess + Collect (with the per-gap FASTQs) on
    the test_collect scenario. Returns (JAX ws, port ws, port cfg)."""
    recs = _gen_records(np.random.default_rng(3))
    cfg, jws, _gaps, _rec, _rs = _pipeline_run(tmp_path, recs, insert_size,
                                               std)
    jcollect.run_collect(cfg, jws, write_parity_files=True)
    tcfg = port_config(cfg, str(tmp_path / "port_work"))
    tws = Workspace(tcfg.workdir)
    tpreprocess.run_preprocess(tcfg, tws, device="cpu")
    tcollect.run_collect(tcfg, tws, write_parity_files=True, device="cpu",
                         **port_kw)
    return jws, tws, tcfg


def assert_collect_equal(jws, tws):
    for name in ("gaps", "recruits", "both_unmapped"):
        assert_same_arrays(jws.load_arrays(name), tws.load_arrays(name), name)
    for sub in PARITY_DIRS:
        assert_same_tree(jws.root, tws.root, sub)
    assert tws.stage_info("collect")["num_recruits"] == \
        jws.stage_info("collect")["num_recruits"]


@pytest.mark.parametrize("insert_size,std", [(900, 100), (300, 50)])
def test_collect_matches_jax(tmp_path, insert_size, std):
    jws, tws, _ = jax_and_port(tmp_path, insert_size, std)
    assert_collect_equal(jws, tws)
    rec = tws.load_arrays("recruits")
    assert len(rec["gap"]) > 50 and rec["hq"].any() and not rec["hq"].all()


def test_collect_python_writer_matches_jax(tmp_path, monkeypatch):
    """The per-gap FASTQs through the Python writer (native library made
    unavailable) are the JAX package's bytes too."""
    monkeypatch.setattr(tnative, "_load", lambda: None)
    jws, tws, _ = jax_and_port(tmp_path, 300, 50)
    assert not tnative.available()
    assert_collect_equal(jws, tws)


def _library(tws, tcfg):
    lib = tcfg.libraries[0]
    aln = tcollect.read_bam_any(lib.bam)
    left = tcollect.read_fastq_any(lib.left_fq)
    right = tcollect.read_fastq_any(lib.right_fq)
    return (tcfg, lib, tws.load_arrays("gaps"),
            tws.load_json("scaffold_names"), aln, left, right)


@pytest.mark.parametrize("insert_size,std", [(900, 100), (300, 50)])
def test_device_union_matches_host_union(tmp_path, insert_size, std):
    """`use_device_union` on and off give the same recruits, and both
    equal the JAX package's collect_library."""
    jws, tws, tcfg = jax_and_port(tmp_path, insert_size, std)
    args = _library(tws, tcfg)
    dev = tcollect.collect_library(*args, device="cpu")
    host = tcollect.collect_library(*args, use_device_union=False,
                                    device="cpu")
    assert set(zip(*(dev[k].tolist() for k in ("gap", "side", "row", "hq")))) \
        == set(zip(*(host[k].tolist() for k in ("gap", "side", "row", "hq"))))
    assert len(dev["gap"]) == len(host["gap"]) > 0
    jargs = (_jax_cfg(tcfg), _jax_lib(tcfg)) + args[2:]
    for union, got in ((True, dev), (False, host)):
        want = jcollect.collect_library(*jargs, use_device_union=union)
        assert_same_arrays({k: np.asarray(v) for k, v in want.items()}, got,
                           f"union={union}")


def _jax_cfg(tcfg):
    from gappadder_tpu import config as jconfig
    d = dataclasses.asdict(tcfg)
    return jconfig.Config(**{
        **d, "libraries": tuple(jconfig.Library(**x) for x in d["libraries"]),
        "tpu": jconfig.TpuParams(**d["tpu"])})


def _jax_lib(tcfg):
    return _jax_cfg(tcfg).libraries[0]


def test_ecap_regrow_matches_default(tmp_path, monkeypatch):
    """Compaction caps of 8 entries overflow in both passes; each batch
    is redone with a larger cap, and the recruits equal the default
    run's (and JAX's)."""
    jws, tws, tcfg = jax_and_port(tmp_path, 300, 50)
    args = _library(tws, tcfg)
    small = dataclasses.replace(tcfg, tpu=dataclasses.replace(
        tcfg.tpu, read_batch=64))
    args = (small,) + args[1:]
    ref = tcollect.collect_library(*args, device="cpu")
    seen = []
    inner = tcollect._compact

    def spy(valid, cols, ecap):
        seen.append((len(cols), ecap, int(valid.sum())))
        return inner(valid, cols, ecap)

    monkeypatch.setattr(tcollect, "_compact", spy)
    monkeypatch.setattr(tcollect, "LOWMAPQ_ECAP", 8)
    grown = tcollect.collect_library(*args, initial_ecap=8, device="cpu")
    for ncols in (7, 3):                 # pass 1, pass 2
        caps = [e for c, e, _ in seen if c == ncols]
        assert caps[0] == 8 and max(caps) > 8, (ncols, caps)
        assert any(n > 8 for c, _, n in seen if c == ncols)
    for k in ("gap", "side", "row", "hq"):
        np.testing.assert_array_equal(ref[k], grown[k], k)
    assert_same_arrays(tws.load_arrays("recruits"),
                       jws.load_arrays("recruits"), "recruits")


def _write_dup_fastqs(tmp_path, cfg, rng):
    """Rewrite the scenario's FASTQs so that some read names repeat in
    one file (the same name on several records, different bases)."""
    for path in (cfg.libraries[0].left_fq, cfg.libraries[0].right_fq):
        recs = open(path).read().splitlines()
        out = []
        for i in range(0, len(recs), 4):
            out.append(recs[i:i + 4])
        n = len(out)
        for j in rng.choice(n, 40, replace=False):
            k = int(rng.integers(0, n))
            out[k] = [out[j][0]] + out[k][1:]      # j's name on record k
        with open(path, "w") as fh:
            fh.write("\n".join(x for r in out for x in r) + "\n")


def test_repeated_read_names_match_jax(tmp_path):
    """Names repeated inside one FASTQ: the hash join finds several rows
    for one name, and the order of equal keys in the sorts decides which
    one; both packages pick the same rows, through both unions."""
    recs = _gen_records(np.random.default_rng(3))
    cfg, jws, _gaps, _rec, _rs = _pipeline_run(tmp_path, recs, 300, 50)
    _write_dup_fastqs(tmp_path, cfg, np.random.default_rng(5))
    names = [tfastq.read_fastq(cfg.libraries[0].left_fq).names]
    assert len(set(names[0])) < len(names[0])
    jcollect.run_collect(cfg, jws, write_parity_files=True)
    tcfg = port_config(cfg, str(tmp_path / "port_work"))
    tws = Workspace(tcfg.workdir)
    tpreprocess.run_preprocess(tcfg, tws, device="cpu")
    tcollect.run_collect(tcfg, tws, write_parity_files=True, device="cpu")
    assert_collect_equal(jws, tws)
    args = _library(tws, tcfg)
    jargs = (_jax_cfg(tcfg), _jax_lib(tcfg)) + args[2:]
    want = jcollect.collect_library(*jargs, use_device_union=False)
    got = tcollect.collect_library(*args, use_device_union=False,
                                   device="cpu")
    assert_same_arrays({k: np.asarray(v) for k, v in want.items()}, got)


def test_collect_entry_points_refuse_without_gpu(tmp_path, monkeypatch):
    jws, tws, tcfg = jax_and_port(tmp_path, 300, 50)
    args = _library(tws, tcfg)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for call in (lambda **kw: tcollect.run_collect(tcfg, tws, **kw),
                 lambda **kw: tcollect.collect_library(*args, **kw)):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            call()
        with pytest.raises(RuntimeError, match="no CUDA device"):
            call(device="cuda")
        assert call(device="cpu") is not None
