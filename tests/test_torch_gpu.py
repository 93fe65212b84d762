"""The port's CUDA paths on a card: the SW, sort, Evaluate, traceback
and probe kernels against their plain versions, the contig refine, and the fused step, the Assembly batch,
Pick, the Assembly+Pick driver, Preprocess and Collect, the CLI and
the multi-setting DBG on the card against their CPU runs.
These
tests need a CUDA device and skip elsewhere; they import no JAX, so
they also run where only the port's dependencies are installed:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_gpu.py
"""

import dataclasses
import os

import numpy as np
import pytest
import torch

from gappadder_tpu_torch import probes
from gappadder_tpu_torch.ops import (dbg, evaluate_dp, merge_engine, psort,
                                     sw_cuda, sw_host, traceback_dp)
from gappadder_tpu_torch.parallel import slice as sl
from gappadder_tpu_torch.probes import int16_repro, swprobe
from gappadder_tpu_torch.probes import kernel_experiments as ke
from gappadder_tpu_torch.testcases import (ARGMAX_INPUTS, DBG_MULTI_CASES,
                                           EVAL_STRIP_ROWS, INT16_LOOP_INPUTS,
                                           SORT_CASES, SW_EDGE_SHAPES,
                                           SW_STRIP_SHAPES, SWPROBE_INPUTS,
                                           SWPROBE_SHAPES,
                                           TRACEBACK_STRIP_ROWS,
                                           dbg_multi_case,
                                           driver_workspace,
                                           evaluate_test_pairs, probe_input,
                                           refine_test_items, sort_case,
                                           sw_edge_pairs, sw_strip_pairs,
                                           sw_test_pairs, traceback_winners)

MODES = ["local", "overlap", "fit", "extend"]


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernel has no CPU form)")
    return torch.device("cuda")


@pytest.mark.gpu
@pytest.mark.parametrize("mode", MODES)
def test_kernel_matches_plain(cuda, mode):
    q, ql, t, tl = sw_test_pairs(23, B=97, Lq=70, Lt=300)
    args = [torch.from_numpy(x).to(cuda) for x in (q, ql, t, tl)]
    slack = 2 if mode == "overlap" else 0
    params = sw_host.SWParams(1, -4, 7, 1)
    before = sw_cuda.launches
    got = sw_cuda.sw_batch_cuda(*args, params, mode, slack)
    want = sw_cuda.sw_batch_plain(*args, params, mode, slack)
    assert sw_cuda.launches == before + 1
    for g, w in zip(got, want):
        assert torch.equal(g, w)


@pytest.mark.gpu
@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("shape", SW_EDGE_SHAPES,
                         ids=lambda s: f"{s[0]}x{s[1]}x{s[2]}")
def test_kernel_matches_plain_at_band_edges(cuda, mode, shape):
    """Query widths around the kernel's bands of rows per lane, with
    targets shorter than a warp and empty ones."""
    B, Lq, Lt = shape
    q, ql, t, tl = sw_edge_pairs(Lq + Lt, B, Lq, Lt)
    args = [torch.from_numpy(x).to(cuda) for x in (q, ql, t, tl)]
    slack = 2 if mode == "overlap" else 0
    params = sw_host.SWParams(2, -3, 5, 2)
    got = sw_cuda.sw_batch_cuda(*args, params, mode, slack)
    want = sw_cuda.sw_batch_plain(*args, params, mode, slack)
    for g, w in zip(got, want):
        assert torch.equal(g, w)


@pytest.mark.gpu
def test_kernel_refuses_wrong_dtype(cuda):
    q = torch.zeros(2, 4, dtype=torch.int32, device=cuda)
    ln = torch.ones(2, dtype=torch.int32, device=cuda)
    with pytest.raises(TypeError):
        sw_cuda.sw_batch_cuda(q, ln, q, ln)


def _evaluate_plain(pairs, device, *sc, max_clip=50):
    """The plain twin on `device`, through the same pack and scatter."""
    pack = evaluate_dp.pack_pairs(pairs)
    out = np.zeros((len(pairs), 6), np.int32)
    out[pack.order] = evaluate_dp.eval_pack_plain(
        pack, device, max_clip=max_clip, match=sc[0], mismatch=sc[1],
        ind=sc[2])
    return out


@pytest.mark.gpu
def test_evaluate_kernel_matches_plain_on_ragged_pairs(cuda):
    """2,000 random ragged pairs of 1-3,000 bases (log-uniform lengths,
    overlaps, containments, N runs) with queries at the strip edges
    (1024, 1025, 2049 rows), in one launch, against the plain twin on
    the card."""
    pairs = evaluate_test_pairs(41, count=2000, lmin=1, lmax=3000,
                                long_rows=EVAL_STRIP_ROWS, long_cols=300,
                                tiny=0, log_lengths=True)
    before = evaluate_dp.launches
    got = evaluate_dp.eval_pairs_device(pairs, 50, device=cuda)
    assert evaluate_dp.launches == before + 1
    np.testing.assert_array_equal(got, _evaluate_plain(pairs, cuda, 1, -2,
                                                       -2))


@pytest.mark.gpu
@pytest.mark.parametrize("max_clip", [0, 2, 50])
def test_evaluate_kernel_matches_plain_on_ties(cuda, max_clip):
    """The tie and edge pairs (lengths 0 and 1, all-N, poly-A, ACAC...,
    tiny two- and three-letter pairs, lines of index below 0) under
    three scorings."""
    pairs = evaluate_test_pairs(50 + max_clip, count=40, lmax=300,
                                long_rows=EVAL_STRIP_ROWS, long_cols=60)
    for sc in ((1, -2, -2), (1, -1, -1), (2, -1, -1)):
        got = evaluate_dp.eval_pairs_device(pairs, max_clip, *sc,
                                            device=cuda)
        np.testing.assert_array_equal(
            got, _evaluate_plain(pairs, "cpu", *sc, max_clip=max_clip))


@pytest.mark.gpu
@pytest.mark.parametrize("rows", ["bands", "strips"])
@pytest.mark.parametrize("mode", ["local", "fit"])
@pytest.mark.parametrize("params", [sw_host.BWA_PARAMS,
                                    sw_host.SWParams(1, -1, 1, 1)],
                         ids=["bwa", "unit"])
def test_traceback_kernel_matches_host(cuda, rows, mode, params):
    """The emulation's cases (tests/test_torch_kernel_emulation.py) on
    the card, in one launch each: every winner's (qstart, tstart, m_sum)
    equal to `sw_host.alignment_stats_batch`'s."""
    kw = (dict(cols=(24, 56), tiny=60, mid=24, dels=24) if rows == "bands" else
          dict(rows=TRACEBACK_STRIP_ROWS, cols=(24, 40), tiny=10,
                   mid=10, dels=10))
    q, ql, t, tl, qend, tend = traceback_winners(
        len(mode) + params.gap_open, mode, **kw)
    before = traceback_dp.launches
    got = traceback_dp.alignment_stats_device(q, ql, t, tl, params, mode,
                                              qend, tend, device=cuda)
    assert traceback_dp.launches == before + 1
    want = sw_host.alignment_stats_batch(q, ql, t, tl, params, mode, qend,
                                         tend)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)


@pytest.mark.gpu
@pytest.mark.parametrize("mode", ["local", "fit"])
def test_traceback_kernel_at_picks_shapes(cuda, mode):
    """A pass at Pick's shapes: 48 flanks of 300 bases (fwd and rc, one
    with N runs) against contigs of 300-2,500 bases holding a mutated
    copy of part of the flank, the contigs N-masked where an earlier
    pass reported a hit; each winner ends where the SW kernel says."""
    from gappadder_tpu_torch.ops import swutil
    rng = np.random.default_rng(22)
    B, FL, LT = 48, 300, 2500
    q = rng.integers(0, 4, (B, FL + 1)).astype(np.int8)
    q[:, FL] = 4
    q[5, 100:120] = 4
    t = np.full((B, LT), 4, np.int8)
    ql = np.full(B, FL, np.int32)
    tl = rng.integers(300, LT + 1, B).astype(np.int32)
    for b in range(B):
        t[b, :tl[b]] = rng.integers(0, 4, tl[b])
        k = int(rng.integers(120, FL + 1))
        at = int(rng.integers(0, tl[b] - k + 1))
        chunk = q[b, FL - k:FL].copy()
        chunk[rng.random(k) < 0.02] = 0
        t[b, at:at + k] = chunk
        lo = int(rng.integers(0, tl[b] - 50))
        t[b, lo:lo + 50] = 4
    _, qend, tend = swutil.sw_pairs(q, ql, t, tl, sw_host.BWA_PARAMS, mode,
                                    device=cuda)
    got = traceback_dp.alignment_stats_device(
        q, ql, t, tl, sw_host.BWA_PARAMS, mode, qend, tend, device=cuda)
    want = sw_host.alignment_stats_batch(q, ql, t, tl, sw_host.BWA_PARAMS,
                                         mode, qend, tend)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)


@pytest.mark.gpu
def test_refine_on_card_matches_cpu(cuda, monkeypatch):
    """`refine_contigs_multi` on testcases' gaps (windows up to 1,100
    bases, so some Evaluate queries take two strips): the card's result
    equals the CPU's, and each `evaluate_pairs` call with pairs is one
    kernel launch, as its span counts it."""
    from gappadder_tpu_torch.pipeline import run
    from gappadder_tpu_torch.utils import meters
    items = refine_test_items(8, n_gaps=4, lmin=600, lmax=2000,
                              win=(150, 1100))
    cfg = merge_engine.MergeConfig()
    calls = []
    inner = merge_engine.evaluate_pairs

    def counted(pairs_seqs, *a, **kw):
        calls.append(len(pairs_seqs))
        return inner(pairs_seqs, *a, **kw)
    monkeypatch.setattr(merge_engine, "evaluate_pairs", counted)
    before = evaluate_dp.launches
    with meters.Meters() as m:
        got = run.refine_contigs_multi(items, cfg, device=cuda)
    launched = evaluate_dp.launches - before
    assert launched == sum(1 for n in calls if n) >= 1
    assert m.stages["assembly.evaluate"]["launches"] == launched
    assert m.stages["assembly.evaluate"]["pairs"] == sum(calls)
    want = run.refine_contigs_multi(items, cfg, device="cpu")
    assert evaluate_dp.launches - before == launched
    for (gc, gn, gi), (wc, wn, wi) in zip(got, want, strict=True):
        assert [c.tolist() for c in gc] == [c.tolist() for c in wc]
        assert gn == wn and gi == wi


@pytest.mark.gpu
def test_toy_step_on_card_matches_cpu(cuda):
    dims, args = sl.example_data(1, gaps_per_shard=2)
    before = sw_cuda.launches
    gpu = [o.cpu().numpy() for o in sl.run_step(dims, args, device=cuda)]
    assert sw_cuda.launches == before + 1
    cpu = [o.numpy() for o in sl.run_step(dims, args, device="cpu")]
    for a, b in zip(gpu, cpu):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)


# the six (k, sub_k) of GAPPadder's configuration.json
KSET6 = ((30, 29), (30, 27), (40, 39), (40, 37), (50, 49), (50, 47))


@pytest.mark.gpu
@pytest.mark.parametrize("caps", [{}, dict(node_cap=0, max_distinct=448)],
                         ids=["uniform", "auto"])
def test_six_setting_step_on_card_matches_cpu(cuda, caps):
    """Block 3 batches the six settings into one DBG call a node cap
    (one with the scenario's cap, two under auto caps): every output of
    the step on the card equals the CPU step's."""
    dims, args = sl.example_data(1, gaps_per_shard=2, read_len=100, step=8,
                                 flank_len=300, gap_len=160, kset=KSET6)
    dims = dataclasses.replace(dims, **caps)
    gpu = [o.cpu().numpy() for o in sl.run_step(dims, args, device=cuda)]
    cpu = [o.numpy() for o in sl.run_step(dims, args, device="cpu")]
    for a, b in zip(gpu, cpu):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)
    assert cpu[8].sum() > 0


@pytest.mark.gpu
@pytest.mark.parametrize("case", list(SORT_CASES))
def test_sort_kernel_matches_plain(cuda, case):
    planes, nk = sort_case(case, seed=len(case))
    ops = [torch.from_numpy(x).to(cuda) for x in planes]
    before = psort.launches
    got = psort.bitonic_sort(ops, nk, stable=True)
    torch.cuda.synchronize()
    assert psort.launches == before + (1 if ops[0].numel() else 0)
    want = psort.bitonic_sort_plain(ops, nk)
    for g, w in zip(got, want):
        assert g.shape == w.shape and g.dtype == w.dtype
        assert torch.equal(g, w)


@pytest.mark.gpu
def test_sort_kernel_takes_strided_planes(cuda):
    rng = np.random.default_rng(4)
    both = torch.from_numpy(rng.integers(0, 9, (5, 300, 3))).to(cuda)
    pay = torch.arange(300, device=cuda).expand(5, 300)
    ops = tuple(both[..., l] for l in range(3)) + (pay,)
    got = psort.bitonic_sort(ops, 3)
    want = psort.bitonic_sort_plain(ops, 3)
    for g, w in zip(got, want):
        assert torch.equal(g, w)


@pytest.mark.gpu
def test_sort_kernel_refuses_wrong_dtype_and_mixed_devices(cuda):
    k32 = torch.zeros(2, 8, dtype=torch.int32, device=cuda)
    with pytest.raises(TypeError):
        psort.bitonic_sort((k32,), 1)
    k = torch.zeros(2, 8, dtype=torch.int64, device=cuda)
    with pytest.raises(ValueError):
        psort.bitonic_sort((k, k.cpu()), 1)


def _toy_batch():
    from gappadder_tpu_torch.config import Config
    from gappadder_tpu_torch.pipeline import run
    dims, args = sl.example_data(1, gaps_per_shard=3, gap_len=(64, 160))
    rowtab = sl.run_step(dims, args, device="cpu")[4].numpy()
    readsets, per_gap, gaps = sl.example_reads(args, rowtab)
    R, md = run._bucket_of(max(len(p) for p in per_gap))
    cfg = Config(draft_genome="d.fa", kmers=((17, 15), (21, 19)))
    return cfg, readsets, per_gap, gaps, R, md, args[22].shape[1]


@pytest.mark.gpu
def test_assemble_batch_on_card_matches_cpu(cuda):
    from gappadder_tpu_torch.pipeline import fused
    cfg, readsets, per_gap, _gaps, R, md, L = _toy_batch()
    batch = [0, 1, 2, -1]
    sorts, sws = psort.launches, sw_cuda.launches
    gpu = fused.assemble_batch(cfg, batch, per_gap, readsets, R, L, md,
                               device=cuda)
    assert psort.launches > sorts and sw_cuda.launches == sws
    cpu = fused.assemble_batch(cfg, batch, per_gap, readsets, R, L, md,
                               device="cpu")
    for f in ("seq", "length", "count"):
        np.testing.assert_array_equal(getattr(gpu, f), getattr(cpu, f))
    assert gpu.names == cpu.names


@pytest.mark.gpu
def test_pick_on_card_matches_cpu(cuda):
    from gappadder_tpu_torch.pipeline import fused, pick
    cfg, readsets, per_gap, gaps, R, md, L = _toy_batch()
    gc = fused.assemble_batch(cfg, [0, 1, 2], per_gap, readsets, R, L, md,
                              device="cpu")
    a = (gaps["flank_left"], gaps["flank_right"], gc.seq, gc.length,
         gc.count)
    before = sw_cuda.launches, traceback_dp.launches
    gpu = pick.align_flanks_to_contigs(*a, min_score=30, device=cuda)
    assert sw_cuda.launches >= before[0] + 2
    assert traceback_dp.launches >= before[1] + 1
    cpu = pick.align_flanks_to_contigs(*a, min_score=30, device="cpu")
    assert gpu == cpu


@pytest.mark.gpu
def test_sw_pairs_refuses_flanks_beyond_the_kernel(cuda):
    """A query longer than one strip of 1024 rows runs in the kernel's
    strips on the card (one launch) and equals the plain version; the
    wrapper still refuses what the kernel does not take."""
    from gappadder_tpu_torch.ops import swutil
    rng = np.random.default_rng(5)
    q = rng.integers(0, 4, (2, 1100)).astype(np.int8)
    ql = np.full(2, 1100, np.int32)
    t = q[:, 500:600].copy()
    before = sw_cuda.launches
    got = swutil.sw_pairs(q, ql, t, ql // 11, sw_host.BWA_PARAMS, "local",
                          device=cuda)
    assert sw_cuda.launches == before + 1
    want = swutil.sw_pairs(q, ql, t, ql // 11, sw_host.BWA_PARAMS, "local",
                           device="cpu")
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)
    assert (got[0] == 100).all()
    with pytest.raises(TypeError):
        sw_cuda.sw_batch_cuda(*[torch.from_numpy(x).to(cuda).long()
                                for x in (q, ql, t, ql)])


@pytest.mark.gpu
@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("shape", SW_STRIP_SHAPES + ((64, 2048, 2048),),
                         ids=lambda s: f"{s[0]}x{s[1]}x{s[2]}")
def test_kernel_matches_plain_in_strips(cuda, mode, shape):
    """Queries of two and three strips of 1024 rows, ties on both sides
    of the strip edge, and the merge screens' 2048 x 2048 bucket; overlap
    mode with an end slack of 50 and one that spans the strips."""
    B, Lq, Lt = shape
    q, ql, t, tl = sw_strip_pairs(Lq + Lt, B, Lq, Lt)
    args = [torch.from_numpy(x).to(cuda) for x in (q, ql, t, tl)]
    params = sw_host.SWParams(2, -3, 5, 2) if Lq % 2 else sw_host.BWA_PARAMS
    for slack in ((50, 1100) if mode == "overlap" else (0,)):
        got = sw_cuda.sw_batch_cuda(*args, params, mode, slack)
        want = sw_cuda.sw_batch_plain(*args, params, mode, slack)
        for g, w in zip(got, want):
            assert torch.equal(g, w)


def _driver_scenario(tmp_path, name):
    """chip_smoke.py's toy driver scenarios: round 1 closes every gap,
    or every gap's inside reads are held back for rescue."""
    from gappadder_tpu_torch.config import Config
    kset = ((17, 15), (21, 19))
    kw, hold = {"round1": (dict(gap_len=(64, 160)), ()),
                "rescue": (dict(gap_len=(84, 100), seed=1), (0, 1, 2))}[name]
    dims, args = sl.example_data(1, gaps_per_shard=3, kset=kset, **kw)
    rowtab = sl.run_step(dims, args, device="cpu")[4].numpy()
    out = []
    for sub in ("card", "cpu"):
        ws, rec, readsets, fills, _ = driver_workspace(
            tmp_path / sub, args, rowtab, hold)
        out.append((ws, rec, readsets))
    return Config(draft_genome="d.fa", kmers=kset), out, fills


def _plain_values(x):
    """Nested dicts, tuples and arrays as plain Python values."""
    if isinstance(x, dict):
        return {k: _plain_values(v) for k, v in x.items()}
    if isinstance(x, (tuple, list)):
        return [_plain_values(v) for v in x]
    if isinstance(x, np.ndarray):
        return (x.dtype.str, x.tolist())
    return x


@pytest.mark.gpu
@pytest.mark.parametrize("name", ["round1", "rescue"])
def test_driver_on_card_matches_cpu(cuda, tmp_path, name):
    from gappadder_tpu_torch.pipeline import run
    cfg, ((ws, rec, rs), (cws, crec, crs)), fills = _driver_scenario(
        tmp_path, name)
    sws, sorts = sw_cuda.launches, psort.launches
    got = run.run_assembly_and_pick(cfg, ws, rec, rs, device=cuda)
    assert sw_cuda.launches > sws and psort.launches > sorts
    want = run.run_assembly_and_pick(cfg, cws, crec, crs, device="cpu")
    for name_ in ("picked_seqs.fa", "picked_seqs.fa_ori.txt",
                  "merge_info.txt"):
        with open(ws.path(name_), "rb") as a, open(cws.path(name_), "rb") as b:
            assert a.read() == b.read(), name_
    for g, w in zip(got, want):        # fills, exts, contig store
        assert _plain_values(g) == _plain_values(w)
    assert sorted(got[0]) == [0, 1, 2]
    for g, (seq, _) in got[0].items():
        np.testing.assert_array_equal(seq, fills[g])


@pytest.mark.gpu
def test_ingest_on_card_matches_cpu(cuda, tmp_path):
    """Preprocess and Collect of a reduced `collect_scenario` (2
    scaffolds of 60 kb, 8 gaps, one open; the paired-end library at 30x
    and a 10 kb mate-pair library) on the card equal the CPU run: the
    .npz arrays and the per-gap FASTQs; the sort kernel runs them."""
    import os
    from gappadder_tpu_torch.pipeline import collect, preprocess
    from gappadder_tpu_torch.pipeline.workspace import Workspace
    from gappadder_tpu_torch.testcases import collect_scenario
    cfg, _truth = collect_scenario(
        str(tmp_path / "scn"), 5, n_scaffolds=2, scaffold_len=60_000,
        gaps_per_scaffold=4, libraries=((300, 50, 100, 30.0),
                                        (10_000, 500, 100, 5.0)), n_open=1)
    wss = []
    for where in (cuda, "cpu"):
        c = dataclasses.replace(cfg, working_folder=str(tmp_path / str(where)))
        ws = Workspace(c.workdir)
        sorts = psort.launches
        preprocess.run_preprocess(c, ws, write_parity_files=True,
                                  device=where)
        collect.run_collect(c, ws, write_parity_files=True, device=where)
        assert (psort.launches > sorts) == (where == cuda)
        wss.append(ws)
    gpu, cpu = wss
    for name in ("gaps", "recruits", "both_unmapped"):
        a, b = gpu.load_arrays(name), cpu.load_arrays(name)
        assert sorted(a) == sorted(b)
        for k in a:
            assert a[k].dtype == b[k].dtype and a[k].shape == b[k].shape
            np.testing.assert_array_equal(a[k], b[k], err_msg=f"{name} {k}")
    assert len(gpu.load_arrays("recruits")["gap"]) > 100
    for sub in ("merged/gap_reads", "merged/gap_reads_high_quality",
                "flank_regions", "."):
        names = sorted(n for n in os.listdir(gpu.path(sub))
                       if n.endswith((".fastq", ".fa", ".txt")))
        assert names and names == sorted(
            n for n in os.listdir(cpu.path(sub))
            if n.endswith((".fastq", ".fa", ".txt")))
        for n in names:
            with open(os.path.join(gpu.path(sub), n), "rb") as a, \
                    open(os.path.join(cpu.path(sub), n), "rb") as b:
                assert a.read() == b.read(), (sub, n)


@pytest.mark.gpu
def test_cli_on_card_matches_cpu(cuda, tmp_path):
    """The CLI's `-c All --parity-files` and `-c Evaluate` on a reduced
    `collect_scenario` (2 scaffolds of 20 kb, 4 gaps, the paired-end
    library), on the card and then with `--device cpu` on the same
    workspace path: every workspace file equal (the .npz files array by
    array, the manifest but for its times); both kernels ran on the
    card; Evaluate hits every gap."""
    import io
    import json
    import shutil
    from contextlib import redirect_stdout
    from gappadder_tpu_torch import cli
    from gappadder_tpu_torch.io import fasta
    from gappadder_tpu_torch.testcases import (collect_scenario, config_dict,
                                               same_workspace)
    scn = tmp_path / "scn"
    cfg, truth = collect_scenario(
        str(scn), 3, n_scaffolds=2, scaffold_len=20_000, gaps_per_scaffold=2,
        libraries=((300, 50, 100, 30.0),), n_open=0,
        kmers=((25, 21), (31, 27)))
    with open(scn / "config.json", "w") as fh:
        json.dump(config_dict(cfg), fh)
    fasta.write_fasta(scn / "truth.fa", [
        (f"scaffold_{i}", s) for i, s in enumerate(truth["scaffolds"])])
    printed = {}
    for where in ("cuda", "cpu"):
        sws, sorts = sw_cuda.launches, psort.launches
        out = io.StringIO()
        with redirect_stdout(out):
            for argv in (["-c", "All", "--parity-files"],
                         ["-c", "Evaluate", "--finished",
                          str(scn / "truth.fa")]):
                assert cli.main(argv + ["-g", str(scn / "config.json"),
                                        "--device", where]) == 0
        printed[where] = out.getvalue()
        launched = sw_cuda.launches > sws and psort.launches > sorts
        assert launched == (where == "cuda")
        if where == "cuda":
            shutil.move(cfg.workdir, str(tmp_path / "card"))
    names = same_workspace(str(tmp_path / "card"), cfg.workdir)
    assert "filled_scaffolds.fa" in names and "hit_list.txt" in names
    assert printed["cuda"] == printed["cpu"]
    hits = open(tmp_path / "card" / "hit_list.txt").read().split()
    assert len(hits) == 4


@pytest.mark.gpu
def test_cli_stages_record_device_memory(cuda, tmp_path):
    """On the card each CLI stage records in metrics.json the device's
    allocated bytes at its end and the process's peak so far, which
    the CLI never resets: a peak reached before the call shows."""
    import json
    from gappadder_tpu_torch import cli
    from gappadder_tpu_torch.testcases import collect_scenario, config_dict
    cfg, _ = collect_scenario(
        str(tmp_path), 3, n_scaffolds=2, scaffold_len=12_000,
        gaps_per_scaffold=2, libraries=((300, 50, 100, 8.0),), n_open=0)
    path = str(tmp_path / "config.json")
    with open(path, "w") as fh:
        json.dump(config_dict(cfg), fh)
    big = torch.empty(1 << 28, dtype=torch.uint8, device=cuda)
    del big
    for command in ("Preprocess", "Collect"):
        assert cli.main(["-c", command, "-g", path]) == 0
    with open(os.path.join(cfg.workdir, "metrics.json")) as fh:
        stage = json.load(fh)["stages"]["collect"]
    assert stage["device_peak_bytes"] >= 1 << 28
    assert 0 <= stage["device_bytes"] <= stage["device_peak_bytes"]
    assert stage["device_peak_bytes"] <= torch.cuda.max_memory_allocated()


def _same_and_counted(key, kernel, plain):
    """kernel() launches its probe kernel once and equals plain()."""
    before = probes.launches[key]
    got = kernel()
    torch.cuda.synchronize()
    assert probes.launches[key] == before + 1
    got = got if isinstance(got, tuple) else (got,)
    want = plain()
    want = want if isinstance(want, tuple) else (want,)
    for g, w in zip(got, want):
        assert g.shape == w.shape and g.dtype == w.dtype
        assert torch.equal(g, w)


@pytest.mark.gpu
@pytest.mark.parametrize("j", [17, 0, 63, 64, 70, -1, -5, -70])
def test_probe_dynamic_sublane_matches_plain(cuda, j):
    t = torch.from_numpy(probe_input("beyond_int16", (64, 128), 3)).to(cuda)
    idx = torch.tensor([[j]], dtype=torch.int32, device=cuda)
    _same_and_counted("dynamic_sublane",
                      lambda: ke.exp_dynamic_sublane(t, idx, device=cuda),
                      lambda: ke.exp_dynamic_sublane_plain(t, idx))


# (S, W) of the loops: the script's, then S no multiple of 32 (lanes
# past the column's last row, partial last bands), R = 32 whole, odd
# widths (the int16 loop's last column pair half dead)
LOOP_SHAPES = [(ke.S, ke.TB), (100, 37), (1000, 9), (1024, 5), (33, 1),
               (5, 3)]


@pytest.mark.gpu
@pytest.mark.parametrize("case", INT16_LOOP_INPUTS)
@pytest.mark.parametrize("S,W", LOOP_SHAPES)
def test_probe_int16_loop_matches_plain(cuda, case, S, W):
    x = torch.from_numpy(probe_input(case, (S, W), 1)).to(cuda)
    _same_and_counted("int16_loop", lambda: ke.exp_int16_loop(x, device=cuda),
                      lambda: ke.exp_int16_loop_plain(x))


@pytest.mark.gpu
@pytest.mark.parametrize("lanes,dpx", [(1, False), (1, True), (2, False),
                                       (2, True)])
@pytest.mark.parametrize("S,W", [(96, 70), (1000, 9)])
def test_probe_loop_yardsticks_match_where_nothing_wraps(cuda, lanes, dpx,
                                                         S, W):
    x = probe_input("beyond_int16", (S, W), 9) // 100
    x = torch.from_numpy(x).to(cuda)
    _same_and_counted(
        "loop_yardstick",
        lambda: ke.recurrence_yardstick(x, 300, lanes=lanes, dpx=dpx),
        lambda: ke.exp_int16_loop_plain(x, 300))


@pytest.mark.gpu
@pytest.mark.parametrize("case", ARGMAX_INPUTS)
@pytest.mark.parametrize("S,W", [(128, 128), (64, 37), *LOOP_SHAPES[1:]])
def test_probe_int32_argmax_matches_plain(cuda, case, S, W):
    x = torch.from_numpy(probe_input(case, (S, W), 2)).to(cuda)
    _same_and_counted(
        "int32_argmax",
        lambda: ke.exp_int32_loop_with_argmax(x, device=cuda),
        lambda: ke.exp_int32_loop_with_argmax_plain(x))


@pytest.mark.gpu
@pytest.mark.parametrize("S,W", [(swprobe.S, swprobe.NBT * swprobe.TB),
                                 *SWPROBE_SHAPES])
@pytest.mark.parametrize("level", swprobe.LEVELS)
def test_probe_swprobe_matches_plain(cuda, level, S, W):
    """Every level over the script's 1152 steps: the script's input at
    its shape, then negative inputs (C's clamp) and inputs near
    INT32_MAX (every add wraps)."""
    xs = [swprobe.script_input(seed=level)] if S == swprobe.S and \
        W == swprobe.NBT * swprobe.TB else []
    xs += [probe_input(name, (S, W), level + S) for name in SWPROBE_INPUTS]
    for x in xs:
        x = torch.from_numpy(x).to(cuda)
        _same_and_counted("swprobe",
                          lambda: swprobe.run(x, level, device=cuda),
                          lambda: swprobe.run_plain(x, level))


@pytest.mark.gpu
@pytest.mark.parametrize("kernel", ["elementwise", "roll"])
@pytest.mark.parametrize("shape", [(32, 128), (7, 33), (300, 5)])
def test_probe_int16_repro_matches_plain(cuda, kernel, shape):
    x = torch.from_numpy(probe_input("int16_full", shape, 4)).to(cuda)
    _same_and_counted(f"int16_{kernel}",
                      lambda: getattr(int16_repro, kernel)(x, device=cuda),
                      lambda: getattr(int16_repro, f"{kernel}_plain")(x))


@pytest.mark.gpu
def test_probe_kernels_refuse_shapes_they_do_not_take(cuda):
    """More than 1024 rows, and an int32 roll, are refused without a
    launch; an odd width of the int16 loop and rows no multiple of 32 of
    the argmax loop are taken and match their plain twins."""
    x = torch.from_numpy(probe_input("near_int16_max", (8, 5), 3)).to(cuda)
    _same_and_counted("int16_loop", lambda: ke.exp_int16_loop(x, device=cuda),
                      lambda: ke.exp_int16_loop_plain(x))
    x = torch.from_numpy(probe_input("float_ties", (48, 8), 3)).to(cuda)
    _same_and_counted(
        "int32_argmax", lambda: ke.exp_int32_loop_with_argmax(x, device=cuda),
        lambda: ke.exp_int32_loop_with_argmax_plain(x))
    before = dict(probes.launches)
    tall = torch.zeros((1025, 8), dtype=torch.int32)
    for run in (ke.exp_int16_loop, ke.exp_int32_loop_with_argmax,
                swprobe.run):
        with pytest.raises(ValueError, match="rows"):
            run(tall, device=cuda)
    with pytest.raises(TypeError):
        int16_repro.roll(torch.zeros((4, 4), dtype=torch.int32), device=cuda)
    assert probes.launches == before


def _offset_view(x: torch.Tensor, offset: int) -> torch.Tensor:
    """`x`'s values in a view `offset` elements into a larger storage."""
    buf = torch.full((x.numel() + offset + 8,), -3, dtype=x.dtype,
                     device=x.device)
    v = buf[offset:offset + x.numel()].view(x.shape)
    v.copy_(x)
    return v


@pytest.mark.gpu
@pytest.mark.parametrize("shape", [(9, 37), (5, 1), (6, 2051)],
                         ids=lambda s: f"{s[0]}x{s[1]}")
def test_probe_dynamic_sublane_takes_any_width(cuda, shape):
    """Rows off the 16-byte vector (widths no multiple of 4), clamped
    rows."""
    t = torch.from_numpy(probe_input("beyond_int16", shape, 3)).to(cuda)
    for j in (0, 1, 2, 3, shape[0], -1, -shape[0] - 2):
        idx = torch.tensor([[j]], dtype=torch.int32, device=cuda)
        _same_and_counted("dynamic_sublane",
                          lambda: ke.exp_dynamic_sublane(t, idx, device=cuda),
                          lambda: ke.exp_dynamic_sublane_plain(t, idx))


@pytest.mark.gpu
@pytest.mark.parametrize("kernel", ["elementwise", "roll"])
@pytest.mark.parametrize("shape", [(1, 7), (1025, 33), (3000, 4097)],
                         ids=lambda s: f"{s[0]}x{s[1]}")
def test_probe_int16_repro_takes_any_rows_and_start(cuda, kernel, shape):
    """One row and more than 1024, odd widths, and inputs that start 2
    and 14 bytes into their storage (the funnel-shifted loads)."""
    x = torch.from_numpy(probe_input("int16_full", shape, 6)).to(cuda)
    for view in (x, _offset_view(x, 1), _offset_view(x, 7)):
        assert view.is_contiguous()
        _same_and_counted(
            f"int16_{kernel}",
            lambda: getattr(int16_repro, kernel)(view, device=cuda),
            lambda: getattr(int16_repro, f"{kernel}_plain")(view))


@pytest.mark.gpu
def test_probe_int16_repro_takes_a_strided_view(cuda):
    wide = torch.from_numpy(probe_input("int16_full", (40, 66), 8)).to(cuda)
    x = wide[:, ::2]
    for kernel in ("elementwise", "roll"):
        _same_and_counted(
            f"int16_{kernel}",
            lambda: getattr(int16_repro, kernel)(x, device=cuda),
            lambda: getattr(int16_repro, f"{kernel}_plain")(x.contiguous()))


@pytest.mark.gpu
def test_probe_launches_on_the_tensors_card_while_another_is_current(cuda):
    """A tensor on cuda:0 while cuda:1 is current: the kernel runs on
    cuda:0, on its current stream, and cuda:1 is current again after."""
    if torch.cuda.device_count() < 2:
        pytest.skip("needs two CUDA devices")
    x = torch.from_numpy(probe_input("int16_full", (33, 70), 9)).to("cuda:0")
    t = torch.from_numpy(probe_input("beyond_int16", (9, 37), 3)).to("cuda:0")
    idx = torch.tensor([[4]], dtype=torch.int32, device="cuda:0")
    with torch.cuda.device(1):
        for dev in ("cuda", torch.device("cuda", 0)):
            out = int16_repro.roll(x, device=dev)
            assert out.device == x.device
            assert torch.cuda.current_device() == 1
            row = ke.exp_dynamic_sublane(t, idx, device=dev)
            assert row.device == t.device
            assert torch.cuda.current_device() == 1
    torch.cuda.synchronize(0)
    assert torch.equal(out, int16_repro.roll_plain(x))
    assert torch.equal(row, ke.exp_dynamic_sublane_plain(t, idx))


@pytest.mark.gpu
def test_two_shards_on_one_card_match_the_one_shard_step(cuda):
    """The toy step over a mesh of two shards of the card: each gap's
    outputs (row shard * Gl + slot of gap shard + 2 * slot) equal the
    one-shard step's on the card, and both shards launched SW."""
    from gappadder_tpu_torch.parallel import mesh, mp
    dev = torch.device("cuda", torch.cuda.current_device())
    dims, args = sl.example_data(2, gaps_per_shard=2, gap_len=(64, 160))
    one = [o.cpu().numpy() for o in sl.run_step(
        dataclasses.replace(dims, n_shards=1, gaps_per_shard=4,
                            entry_cap=2 * dims.entry_cap), args)]
    m = mesh.make_mesh((2,), ("dp",), [dev, dev])
    before = sw_cuda.launches
    two = [mp.to_np(o) for o in
           sl.make_slice_step(m, dims)(*sl.place_args(m, args))]
    assert sw_cuda.launches == before + 2
    shard, slot = sl.home_of(np.arange(dims.n_gaps), 2)
    rows = shard * dims.gaps_per_shard + slot
    for a, b in list(zip(one, two))[3:]:
        np.testing.assert_array_equal(a, b[rows])
    assert two[0][:7].tolist() == one[0][:7].tolist()


@pytest.mark.gpu
@pytest.mark.parametrize("name", list(DBG_MULTI_CASES))
def test_dbg_multi_on_the_card_matches_the_cpu(cuda, name):
    """The multi-setting DBG on the card equals its CPU run, every output
    of every setting, at the toy batches of the CPU parity tests."""
    settings, ks, nk, kc, kw = dbg_multi_case(name)
    outs = []
    before = psort.launches
    for dev in (cuda, torch.device("cpu")):
        on = lambda xs: None if xs is None else [
            torch.from_numpy(x).to(dev) for x in xs]
        outs.append(dbg.assemble_unitigs_multi(on(ks), on(nk), on(kc),
                                               settings=settings, **kw))
    assert psort.launches > before
    for got, want in zip(*outs):
        for g, w in zip(got, want):
            assert torch.equal(g.cpu(), w)
