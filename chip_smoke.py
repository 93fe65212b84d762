"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Builds the hand-written kernels from `gappadder_tpu_torch/csrc/` (the
SW kernel `sw.cu`, the sort `sort.cu` and the probe kernels
`probes.cu`), holds each against its plain PyTorch version on the card,
and drives the port's paths at the production size: the fused
collect->assemble->pick step (`parallel.slice.run_step`: 64 gaps, six
(k, sub_k) settings, 300 bp flanks, 100 bp reads, 100-1000 bp gaps),
the shipped Assembly batch (`pipeline.fused.assemble_batch`) on that
scenario's reads, and the Pick stage (`pipeline.run._pick_gaps`) on its
contigs. It checks their outputs, fires the capacity checks and the cap
growth, and times the step, the kernels, the Assembly batch and Pick
with CUDA events and host clocks. The kernel checks cover the edges of
the SW kernel's bands of rows per lane and the sort's tile sizes; the
SW times come at the step's block-4 batch and at Pick's own buckets,
with the share of the kernel's lane-row cell slots that are live
cells; the sort times come at each call shape of the step, with its
CUDA launches per call and, for one and two keys, one stable
`torch.sort` computing the same. Then the probes path: the probe
modules' `main()`s run as their JAX scripts in `scripts/` do, each
probe kernel is held to its plain twin (also at a width that fills the
card) and timed against its bound, and the loops' step loops are read
from their SASS (instructions and warp reductions a step) and ptxas
report (registers, spills). Last, the driver path
(`pipeline.run.run_assembly_and_pick`: round 1, the contig merge,
rescue, round 2, the HQ pseudo-contigs and the final pick): two toy
workspaces whose files, fills and contig stores must equal the port's
CPU run byte for byte, then the production scenario with the inside
reads of its 8 gaps nearest 250 bp held back for rescue, which must fill
all 64 gaps with the planted bases; every SW and sort call of that run
is held to the plain version on its own inputs, and the `driver_time`
line gives each stage's host-clock ms and the SW kernel at the merge's
shapes. Then the ingest chain on files (`testcases.collect_scenario`: a
4.6 Mbp draft with 64 gaps, 4 of them open, a paired-end library at 30x
and a mate-pair one at 5x, written as FASTA, BAM and FASTQ): Preprocess,
Collect, the driver and Patch on the card, Preprocess and Collect held
to the CPU run file for file, every sort and SW call shape held to the
plain version, the 60 closable gaps filled with the planted bases and
filled_scaffolds.fa equal to the truth over them; the `collect_time`
line gives each part's host-clock ms and the sort kernel at Collect's
shapes. Last, the CLI (`cli.main`, in this process) on the same files:
`-c All` writes the direct calls' workspace, a second `-c All` finds it
up to date, `-c Evaluate` hits every closable gap with every SW call
shape it made held to the plain version, `-c Assembly --trace` names
the kernels in its trace, the non-fused Assembly batch writes the fused
run's files with every SW and sort call shape held to the plain
version, and the tools on the card equal the CPU; the `cli_time` line
gives the CLI's per-stage seconds, Evaluate's parts and the non-fused
k-mer merge's sort shapes. The chain's config sets `tpu.mesh_shape` [2],
which one process on one card runs unsharded. Then the multi-device
runs: one process with two shards on the card (phase 14: the production
step through `make_slice_step` over a mesh of two shards of cuda:0 and
the production Assembly batch over it, gap for gap equal to the
one-shard runs, every SW and sort call shape held to the plain version,
the two steps timed in turns), and two processes on the card (phase 15:
`parallel/mp_slice_worker.py` at the production shape equal to phase
14, and the CLI's `-c All --coordinator` on the chain's files, split
over the mesh, gloo between the ranks, writing phase 13's workspace
byte for byte; in every rank of both, every SW and sort call shape held
to the plain version).

Prints JSON lines along the way; the line before the last is the
`kernels` record and the last line is
{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}.
Any failed phase raises, so the exit code is non-zero and no result
line is printed. Exits non-zero at once when no CUDA device is present.
"""

from __future__ import annotations

import contextlib
import dataclasses
import gc
import json
import os
import re
import subprocess
import sys
import tempfile
import time
import warnings

import numpy as np
import torch

PRODUCTION_KSET = ((30, 29), (30, 27), (40, 39), (40, 37), (50, 49), (50, 47))
PRODUCTION = dict(gaps_per_shard=64, read_len=100, step=4, flank_len=300,
                  gap_len=(100, 1000), kset=PRODUCTION_KSET)
# int32 operations a local-mode DP cell needs: H - go 1 (shared by the
# E to the right and the F below), E 2, F 2, substitution 2, diag + s 1,
# three maxes (diag vs E, vs F, vs 0)
SW_OPS_PER_CELL = 11
HBM_BYTES_PER_S = 3.35e12  # H100 SXM data sheet
N_WINDOWS, STEPS_PER_WINDOW = 5, 5
# the probe kernels on the probes path, by launch counter: the name in
# the kernels line and the TPU kernel each replaces
PROBE_KERNELS = {
    "dynamic_sublane": ("exp_dynamic_sublane",
                        "scripts/tpu_kernel_experiments.py:21"),
    "int16_loop": ("exp_int16_loop", "scripts/tpu_kernel_experiments.py:40"),
    "int32_argmax": ("exp_int32_loop_with_argmax",
                     "scripts/tpu_kernel_experiments.py:85"),
    "swprobe": ("swprobe.run", "scripts/swprobe.py:80"),
    "int16_elementwise": ("int16_repro.elementwise",
                          "scripts/mosaic_int16_repro.py:51"),
    "int16_roll": ("int16_repro.roll", "scripts/mosaic_int16_repro.py:55"),
}
# int32 (or int16x2) operations an element and step needs, counted from
# the code, each max(a + b, c) as one (Hopper's DPX issues it as one
# instruction). The int16 loop: e - 1, max(h - 1, e'), max(above + 1,
# e), the floor: 4 a lane word, two elements a word in int16x2. The
# argmax loop: 3 for e and h, the float cast, and the column reduction's
# combine (max, compare, two selects) once an element.
OPS_LOOP_WORD = 4
OPS_ARGMAX = 8
# swprobe's step by level, a row: 1 is max(A - 1, tr) 1; 2 adds A - 7
# and max(B - 2, .) 2, C's max with the row above 1, A's max 1; 3 adds
# D's max(above, C - 1) 1, E's max 1, sc's compare and select and A's
# add-max 3, B's row <= s compare and select 2, max(C, 0) 1. Row 0's
# selects (A = tr, C and D from A, E from C, B's row >= 1) are one row's
# work a column, not every row's, so they are not counted. The final
# A + B + C + D + E and column max: 5 an element, once.
SW_LEVEL_OPS = {0: 0, 1: 1, 2: 5, 3: 13}
YARDSTICKS = ((1, False), (1, True), (2, True))   # (lanes, dpx)
# rows 4 and 5 held to plain also off the script's shape: S no multiple
# of 32, with lanes past the column's last row (5, 100) and a partial
# last band (33, 1000); R = 32 with every row live (1024); odd widths
# (the int16 loop's last column pair half dead)
LOOP_SHAPES = ((100, 37), (1000, 9), (1024, 5), (33, 1), (5, 3))
# rows 3 and 7 (the copies): interleaved windows of calls at the script
# shapes; where bytes set the time (t int32 [16, 2^24], row 11; int16
# [32, 2^22]) fewer calls a window; an odd int16 shape (tails, a start
# 2 bytes into its storage, more than 1024 rows); the host's parts of
# one call, each timed over 10,000 calls
COPY_WINDOWS, COPY_REPS, FILL_REPS = 7, 50, 10
SUBLANE_FILL = (16, 1 << 24, 11)
INT16_FILL = (32, 1 << 22)
INT16_ODD = (3000, 4097)
HOST_PART_CALLS, HOST_PART_ROUNDS = 10_000, 5
FILL_TILES_PER_SM = 4
# clock cycles of the sleep kernel that holds the stream while the host
# issues the calls `events_device_ms` times (about 20 ms at 2 GHz)
SLEEP_CYCLES = 40_000_000
MODES = ("local", "overlap", "fit", "extend")
# the merge's screens send whole contigs: the 2048-row bucket of a
# production contig of 1025-2048 bases, against the same bucket
MERGE_SW_SHAPE = (64, 2048, 2048)
TOY_KSET = ((17, 15), (21, 19))
# the toy driver scenarios (example_data keywords, gaps held back):
# round 1 closes every gap, or every gap's inside reads are held back so
# that rescue and round 2 must close it
TOY_DRIVERS = {"round1": (dict(gap_len=(64, 160)), ()),
               "rescue": (dict(gap_len=(84, 100), seed=1), (0, 1, 2))}
HELD_BACK_GAPS, HELD_BACK_NEAR = 8, 250
DRIVER_FILES = ("picked_seqs.fa", "picked_seqs.fa_ori.txt", "merge_info.txt")


def emit(**kw):
    print(json.dumps(kw), flush=True)


def smi(query: str) -> str:
    out = subprocess.run(
        ["nvidia-smi", f"--query-gpu={query}", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout
    return out.strip().splitlines()[0]


def step_window(fn, steps: int) -> dict:
    """`steps` back-to-back calls of fn in one CUDA-event window: device
    ms per call, and the host's wall and main-thread CPU ms per call
    spent issuing them (the loop alone, before the closing sync). Issue
    time near the device time means the host sets the pace. Also the
    host probe's time just before the window."""
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    probe = host_probe_ms()
    w0, c0 = time.perf_counter(), time.thread_time()
    start.record()
    for _ in range(steps):
        fn()
    end.record()
    w1, c1 = time.perf_counter(), time.thread_time()
    torch.cuda.synchronize()
    return {"ms_per_step": start.elapsed_time(end) / steps,
            "issue_ms_per_step": (w1 - w0) * 1e3 / steps,
            "issue_cpu_ms_per_step": (c1 - c0) * 1e3 / steps,
            "host_probe_ms": probe}


def host_probe_ms() -> float:
    """Milliseconds of a fixed pure-Python loop: how fast the host thread
    runs at this moment, to read the step's spread against."""
    t0 = time.perf_counter()
    sum(i * i for i in range(300_000))
    return (time.perf_counter() - t0) * 1e3


def count_syncs(fn) -> int:
    """Host-device synchronisations in one call of fn, as torch's sync
    debug mode reports them."""
    torch.cuda.synchronize()
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            fn()
        finally:
            torch.cuda.set_sync_debug_mode("default")
    torch.cuda.synchronize()
    return sum("synchroniz" in str(w.message) for w in caught)


def cuda_ms(fn, reps: int) -> float:
    """Mean milliseconds of fn() over `reps` runs, by CUDA events."""
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def check_sw(sw_cuda, q, ql, t, tl, params, mode, slack, dev):
    """Kernel vs plain on the card (numpy inputs or tensors there);
    returns the max abs difference."""
    args = [x if torch.is_tensor(x) else torch.from_numpy(x).to(dev)
            for x in (q, ql, t, tl)]
    got = sw_cuda.sw_batch_cuda(*args, params, mode, slack)
    want = sw_cuda.sw_batch_plain(*args, params, mode, slack)
    err = max(int((g.long() - w.long()).abs().max())
              for g, w in zip(got, want))
    if err:
        raise AssertionError(f"sw kernel != plain: mode={mode} "
                             f"params={params} slack={slack} err={err}")
    return err


def check_sort(psort, ops, nk) -> int:
    """Sort kernel vs plain on the card, every plane exactly; returns
    the max abs difference (0)."""
    got = psort.bitonic_sort(ops, nk, stable=True)
    want = psort.bitonic_sort_plain(ops, nk)
    for g, w in zip(got, want):
        if g.shape != w.shape or g.dtype != w.dtype or not torch.equal(g, w):
            diff = (g - w).abs().max() if g.numel() else 0
            raise AssertionError(f"sort kernel != plain: shape="
                                 f"{tuple(w.shape)} keys={nk} err={diff}")
    return 0


@contextlib.contextmanager
def patched(module, name, value):
    """Temporarily replace `module.name` (restored on exit)."""
    old = getattr(module, name)
    setattr(module, name, value)
    try:
        yield
    finally:
        setattr(module, name, old)


@contextlib.contextmanager
def recording_sw(module):
    """Route `module`'s SW kernel calls (its `sw_batch_cuda`: swutil's,
    or the step's in parallel/slice.py) as before, keeping a copy of
    each call's inputs: yields a list of (q, qlen, t, tlen, params,
    mode, end_slack)."""
    calls = []
    inner = module.sw_batch_cuda

    def record(q, qlen, t, tlen, params, mode="local", end_slack=0):
        calls.append((q.clone(), qlen.clone(), t.clone(), tlen.clone(),
                      params, mode, end_slack))
        return inner(q, qlen, t, tlen, params, mode, end_slack)

    with patched(module, "sw_batch_cuda", record):
        yield calls


@contextlib.contextmanager
def recording_sorts(psort):
    """Route psort.bitonic_sort through the kernel as before, keeping the
    number of calls and a copy of the last call's planes at each
    distinct (shape, keys, payloads): yields {key: [calls, planes]}."""
    calls: dict = {}
    inner = psort.bitonic_sort

    def record(ops, num_keys, stable=False):
        ops = tuple(ops)
        key = (tuple(ops[0].shape), num_keys, len(ops) - num_keys)
        calls[key] = [calls.get(key, [0])[0] + 1, [o.clone() for o in ops]]
        return inner(ops, num_keys, stable)

    with patched(psort, "bitonic_sort", record):
        yield calls


def same_contigs(a, b) -> bool:
    return (all(np.array_equal(getattr(a, f), getattr(b, f))
                for f in ("seq", "length", "count")) and a.names == b.names)


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    from gappadder_tpu_torch.config import Config
    from gappadder_tpu_torch.ops import cuda_build, psort, sw_cuda, sw_host
    from gappadder_tpu_torch.ops import swutil
    from gappadder_tpu_torch.ops.sw_host import BWA_PARAMS, SWParams
    from gappadder_tpu_torch.parallel import slice as sl
    from gappadder_tpu_torch.pipeline import fused, run
    from gappadder_tpu_torch.testcases import (SORT_CASES, SW_EDGE_SHAPES,
                                               SW_STRIP_SHAPES, sort_case,
                                               sw_edge_pairs, sw_strip_pairs,
                                               sw_test_pairs)
    from gappadder_tpu_torch.utils import log
    from gappadder_tpu_torch import probes
    from gappadder_tpu_torch.probes import (int16_repro, kernel_experiments,
                                            swprobe)

    def reset_counts():
        """Every kernel's launch count to 0, just before a path runs."""
        sw_cuda.launches = psort.launches = 0
        for k in probes.launches:
            probes.launches[k] = 0

    def read_counts() -> dict:
        return {"sw": sw_cuda.launches, "sort": psort.launches,
                **probes.launches}

    dev = torch.device("cuda", 0)
    card = smi("name,power.limit")
    print(card, flush=True)
    props = torch.cuda.get_device_properties(0)
    sm_clock_mhz = float(smi("clocks.max.sm").split()[0])
    emit(phase="device", name=torch.cuda.get_device_name(0), smi=card,
         sms=props.multi_processor_count, max_sm_clock_mhz=sm_clock_mhz,
         torch=torch.__version__, cuda=torch.version.cuda)

    # ---- phase 1: build ---------------------------------------------------
    t0 = time.time()
    reports = cuda_build.build_all()
    emit(phase="build", seconds=round(time.time() - t0, 3),
         built=sorted(reports))
    for name, log_text in reports.items():
        print(f"[nvcc {name}]\n{log_text}", file=sys.stderr)

    # ---- phase 2: SW kernel == plain on the card ---------------------------
    max_err = 0
    n_checks = 0
    for mode in ("local", "overlap", "fit", "extend"):
        for params in (BWA_PARAMS, SWParams(), SWParams(2, -3, 5, 2)):
            for B, Lq, Lt in ((67, 24, 48), (40, 65, 33), (9, 300, 700)):
                q, ql, t, tl = sw_test_pairs(n_checks, B, Lq, Lt)
                slack = 3 if mode == "overlap" else 0
                max_err = max(max_err, check_sw(sw_cuda, q, ql, t,
                                                tl, params, mode, slack, dev))
                n_checks += 1
    # the step's block-4 shape, then Pick's bucketed local and fit shape
    for (B, Lq, Lt), mode in (((6144, 300, 2048), "local"),
                              ((2048, 512, 2048), "local"),
                              ((2048, 512, 2048), "fit")):
        q, ql, t, tl = sw_test_pairs(n_checks, B, Lq, Lt)
        max_err = max(max_err, check_sw(sw_cuda, q, ql, t, tl,
                                        BWA_PARAMS, mode, 0, dev))
        n_checks += 1
    # query widths around the kernel's bands of rows per lane, with
    # targets shorter than a warp and empty ones
    for mode in ("local", "overlap", "fit", "extend"):
        for si, (B, Lq, Lt) in enumerate(SW_EDGE_SHAPES):
            params = (BWA_PARAMS, SWParams(), SWParams(2, -3, 5, 2))[si % 3]
            q, ql, t, tl = sw_edge_pairs(100 + si, B, Lq, Lt)
            slack = 2 if mode == "overlap" else 0
            max_err = max(max_err, check_sw(sw_cuda, q, ql, t, tl, params,
                                            mode, slack, dev))
            n_checks += 1
    # queries past one strip of 1024 rows: ties on both sides of the
    # strip edge, fit mode's row at the edge, the merge screens' bucket;
    # overlap mode with the merge's end slack and one spanning the strips
    strip_shapes = SW_STRIP_SHAPES + (MERGE_SW_SHAPE,)
    for mode in MODES:
        for B, Lq, Lt in strip_shapes:
            q, ql, t, tl = sw_strip_pairs(Lq + Lt, B, Lq, Lt)
            params = SWParams(2, -3, 5, 2) if Lq % 2 else BWA_PARAMS
            for slack in ((50, 1100) if mode == "overlap" else (0,)):
                max_err = max(max_err, check_sw(sw_cuda, q, ql, t, tl,
                                                params, mode, slack, dev))
                n_checks += 1
    emit(phase="sw_check", cases=n_checks, max_abs_err=max_err,
         production_shapes=[[6144, 300, 2048, "local"],
                            [2048, 512, 2048, "local"],
                            [2048, 512, 2048, "fit"]],
         edge_shapes=[list(x) for x in SW_EDGE_SHAPES],
         strip_shapes=[list(x) for x in strip_shapes],
         rows_per_lane={Lq: sw_cuda.rows_per_lane(Lq)
                        for Lq in sorted({x[1] for x in SW_EDGE_SHAPES}
                                         | {300, 512})},
         strips={Lq: sw_cuda.strips(Lq) for _, Lq, _ in strip_shapes})

    # ---- phase 3: sort kernel == plain on the card -------------------------
    sort_err = 0
    for name in SORT_CASES:
        planes, nk = sort_case(name, seed=len(name))
        ops = [torch.from_numpy(x).to(dev) for x in planes]
        sort_err = max(sort_err, check_sort(psort, ops, nk))
    emit(phase="sort_check", cases=len(SORT_CASES),
         names=list(SORT_CASES), max_abs_err=sort_err)

    # ---- phase 4: toy step on the card == the port's CPU run ---------------
    dims, args = sl.example_data(1, gaps_per_shard=2)
    sorts = psort.launches
    gpu = [o.cpu().numpy() for o in sl.run_step(dims, args)]
    if psort.launches == sorts:
        raise AssertionError("toy step did not launch the sort kernel")
    cpu = [o.numpy() for o in sl.run_step(dims, args, device="cpu")]
    names = ("counts", "hist", "n_recv", "n_reads", "rowtab", "hqtab",
             "useq", "ulen", "ucnt", "score", "qend", "tend")
    for nm, a, b in zip(names, gpu, cpu):
        if a.dtype != b.dtype or a.shape != b.shape or not (a == b).all():
            raise AssertionError(f"toy step: {nm} differs card vs CPU")
    counts, _, _, n_reads, _, _, _, ulen, _, sc = gpu[:10]
    assert int(counts[0]) == dims.n_gaps * 25
    sl.check_overflow(dims, counts)
    assert int(n_reads.sum()) == dims.n_gaps * 25
    assert (ulen.max(axis=1) >= 128).all()
    assert (sc[:, 0:2].max(axis=(1, 2)) == 40).all()
    assert (sc[:, 2:4].max(axis=(1, 2)) == 40).all()
    emit(phase="toy_step", outputs_equal_cpu=True, closure=True,
         sort_launches=psort.launches - sorts)

    # ---- phase 5: the production step --------------------------------------
    pdims, pargs = sl.example_data(1, **PRODUCTION)
    pin = sl.inputs_from_numpy(pargs, dev)
    reset_counts()
    out = sl.run_step(pdims, pin)
    torch.cuda.synchronize()
    launches = {"step": read_counts()}
    if min(launches["step"]["sw"], launches["step"]["sort"]) < 1:
        raise AssertionError(f"production step launches {launches['step']}")
    res = [o.cpu().numpy() for o in out]
    counts, ulen, sc = res[0], res[7], res[9]
    sl.check_overflow(pdims, counts)
    glens = pargs[17] - pargs[16]          # gap_end - gap_start
    mu = pdims.max_unitigs
    for s, (k, _sk) in enumerate(pdims.kset):
        short = np.nonzero(ulen[:, s * mu] < glens + k)[0]
        if len(short):
            raise AssertionError(f"setting {s} did not assemble through "
                                 f"gaps {short.tolist()}")
    assert (sc[:, 0:2].max(axis=(1, 2)) >= 80).all(), "left flank unanchored"
    assert (sc[:, 2:4].max(axis=(1, 2)) >= 80).all(), "right flank unanchored"
    myg = torch.arange(pdims.gaps_per_shard, device=dev)
    pq, pql, pt, ptl, live = sl.pick_inputs(
        out[6], out[7], pin[24][myg], pin[25][myg], pin[26][myg],
        pin[27][myg])
    plain = sw_cuda.sw_batch_plain(pq, pql, pt, ptl, BWA_PARAMS, "local")
    kern = sw_cuda.sw_batch_cuda(pq, pql, pt, ptl, BWA_PARAMS, "local")
    for r, p, k in zip(out[9:12], plain, kern):
        if not torch.equal(p, k):
            raise AssertionError("block-4 kernel != plain at production")
        zero = torch.zeros_like(r)
        if not torch.equal(r, torch.where(live, p.reshape(live.shape), zero)):
            raise AssertionError("step's block-4 outputs != plain SW")
    # the step with the plain sort gives the same 12 outputs
    with patched(psort, "bitonic_sort", psort.bitonic_sort_plain):
        out_plain = sl.run_step(pdims, pin)
    for nm, a, b in zip(names, out, out_plain):
        if not torch.equal(a, b):
            raise AssertionError(f"production step: {nm} differs between "
                                 "the sort kernel and the plain sort")
    emit(phase="production_step", n_gaps=pdims.n_gaps,
         counts=counts.tolist(), launches=launches["step"],
         sw_batch=list(pq.shape) + [pt.shape[1]], block4_equal_plain=True,
         outputs_equal_plain_sort=True)

    # ---- phase 6: undersized caps fire check_overflow ----------------------
    for field, tiny in (("entry_cap", 8), ("reads_per_gap", 4),
                        ("max_distinct", 32)):
        d3 = dataclasses.replace(dims, **{field: tiny})
        c3 = sl.run_step(d3, args)[0].cpu().numpy()
        try:
            sl.check_overflow(d3, c3)
        except OverflowError:
            continue
        raise AssertionError(f"undersized {field} did not trip check_overflow")
    emit(phase="cap_stress", fired=["entry_cap", "reads_per_gap",
                                    "max_distinct"])

    # ---- phase 7: the shipped Assembly batch -------------------------------
    # toy batch: card == the port's CPU run
    tdims, targs = sl.example_data(1, gaps_per_shard=3, gap_len=(64, 160))
    trow = sl.run_step(tdims, targs, device="cpu")[4].numpy()
    trs, tpg, _ = sl.example_reads(targs, trow)
    tR, tmd = run._bucket_of(max(len(p) for p in tpg))
    tcfg = Config(draft_genome="draft.fa", kmers=((17, 15), (21, 19)))
    tb, tL = [0, 1, 2, -1], targs[22].shape[1]
    tgpu = fused.assemble_batch(tcfg, tb, tpg, trs, tR, tL, tmd)
    tcpu = fused.assemble_batch(tcfg, tb, tpg, trs, tR, tL, tmd, device="cpu")
    if not same_contigs(tgpu, tcpu):
        raise AssertionError("toy Assembly batch differs card vs CPU")
    # production: the step's reads and per-gap recruits, shipped defaults
    readsets, per_gap, gaps = sl.example_reads(pargs, res[4])
    R, md = run._bucket_of(max(len(p) for p in per_gap))
    cfg = Config(draft_genome="draft.fa", kmers=PRODUCTION_KSET)
    batch = list(range(pdims.n_gaps))
    L = pargs[22].shape[1]
    assert cfg.tpu.gap_batch == len(batch)
    reset_counts()
    log.reset_cap_events()
    with recording_sorts(psort) as shipped_sorts:
        contigs = fused.assemble_batch(cfg, batch, per_gap, readsets, R, L,
                                       md)
    launches["assemble_batch"] = read_counts()
    if launches["assemble_batch"]["sort"] < 1:
        raise AssertionError("assemble_batch did not launch the sort kernel")
    grow_keys = ("kmer_table_grow", "dbg_node_cap_grow", "unitig_slots_grow",
                 "contig_len_grow")
    shipped_events = {k: log.cap_events(k) for k in grow_keys}
    check_closure(contigs, glens, cfg.kmers)
    # a small starting distinct-k-mer table: the caps have to grow
    log.reset_cap_events()
    small_md = 1024
    with recording_sorts(psort) as grow_sorts:
        grown = fused.assemble_batch(cfg, batch, per_gap, readsets, R, L,
                                     small_md)
    grow_events = {k: log.cap_events(k) for k in grow_keys}
    if not any(grow_events.values()):
        raise AssertionError("no cap grew from max_distinct=1024")
    check_closure(grown, glens, cfg.kmers)
    # every call shape of both batches: the kernel == plain on the
    # batch's own planes; then both batches with the plain sort give
    # the same contigs and names
    asm_shapes = []
    for calls in (shipped_sorts, grow_sorts):
        for (shape, nk, npay), (count, ops) in sorted(calls.items()):
            sort_err = max(sort_err, check_sort(psort, ops, nk))
            asm_shapes.append([list(shape), nk, npay, count])
    del shipped_sorts, grow_sorts
    with patched(psort, "bitonic_sort", psort.bitonic_sort_plain):
        for got, start in ((contigs, md), (grown, small_md)):
            want = fused.assemble_batch(cfg, batch, per_gap, readsets, R, L,
                                        start)
            if not same_contigs(got, want):
                raise AssertionError(f"Assembly batch from md={start} "
                                     "differs between the sort kernel and "
                                     "the plain sort")
    emit(phase="assembly", toy_equal_cpu=True, n_gaps=len(batch), R=R,
         max_distinct=md, contigs_per_gap=[int(contigs.count.min()),
                                           int(contigs.count.max())],
         launches=launches["assemble_batch"], shipped_events=shipped_events,
         grow_from_max_distinct=small_md, grow_events=grow_events,
         closed_every_gap_every_setting=True,
         sort_shapes_equal_plain=asm_shapes, contigs_equal_plain_sort=True)

    # ---- phase 8: Pick ------------------------------------------------------
    store = {g: run._tuple_from_list(
        [contigs.seq[g, j, :contigs.length[g, j]]
         for j in range(int(contigs.count[g]))], contigs.names[g])
        for g in batch}
    truth = sl.example_fills(pargs, per_gap)
    pick_times = {"sw_ms": 0.0, "host_ms": 0.0}

    def timed(fn, key):
        def wrapper(*a, **kw):
            t = time.perf_counter()
            try:
                return fn(*a, **kw)
            finally:
                pick_times[key] += (time.perf_counter() - t) * 1e3
        return wrapper

    fills, exts = {}, {}
    reset_counts()
    t = time.perf_counter()
    with patched(swutil, "sw_pairs", timed(swutil.sw_pairs, "sw_ms")), \
            patched(sw_host, "alignment_stats_batch",
                    timed(sw_host.alignment_stats_batch, "host_ms")), \
            recording_sw(swutil) as pick_sw:
        run._pick_gaps(cfg, gaps, batch, store, fills, exts,
                       cfg.pick_min_score_round1, False)
    pick_ms = dict(pick_times, total_ms=(time.perf_counter() - t) * 1e3)
    launches["pick"] = read_counts()
    if launches["pick"]["sw"] < 1:
        raise AssertionError("Pick did not launch the SW kernel")
    missing = [g for g in batch if g not in fills]
    if missing:
        raise AssertionError(f"Pick left gaps {missing} unfilled")
    wrong = [g for g in batch if not np.array_equal(fills[g][0], truth[g])]
    if wrong:
        raise AssertionError(f"Pick's fills of gaps {wrong} differ from the "
                             "planted bases")
    emit(phase="pick", n_gaps=len(batch), filled=len(fills),
         equal_planted=True, min_score=cfg.pick_min_score_round1,
         launches=launches["pick"])

    # ---- phase 9: times ----------------------------------------------------
    step = lambda: sl.run_step(pdims, pin)
    with patched(psort, "bitonic_sort", psort.bitonic_sort_plain):
        step()
    step()                                               # warm-up
    emit(phase="host", cpu_count=os.cpu_count(), loadavg=os.getloadavg(),
         torch_threads=torch.get_num_threads(), smi=card)
    # the step with the sort kernel and with the plain sort, in
    # alternating turns (kernel, plain, plain, kernel, ...)
    windows, plain_windows = [], []
    for i in range(N_WINDOWS):
        for use_kernel in ((True, False) if i % 2 == 0 else (False, True)):
            if use_kernel:
                windows.append(step_window(step, STEPS_PER_WINDOW))
            else:
                with patched(psort, "bitonic_sort", psort.bitonic_sort_plain):
                    plain_windows.append(step_window(step, STEPS_PER_WINDOW))
    gc.collect()
    gc.disable()
    try:
        nogc = [step_window(step, STEPS_PER_WINDOW) for _ in range(N_WINDOWS)]
    finally:
        gc.enable()
    single = [step_window(step, 1) for _ in range(5)]
    per_step = sorted(w["ms_per_step"] for w in windows)
    step_ms = per_step[len(per_step) // 2]
    plain_step = sorted(w["ms_per_step"] for w in plain_windows)
    syncs = count_syncs(step)
    col = lambda ws, key: [w[key] for w in ws]
    emit(phase="step_time", step_ms=step_ms,
         gaps_per_s=pdims.n_gaps / (step_ms / 1e3), n_gaps=pdims.n_gaps,
         steps_per_window=STEPS_PER_WINDOW,
         window_ms_per_step=col(windows, "ms_per_step"),
         spread_ms=per_step[-1] - per_step[0],
         window_issue_ms_per_step=col(windows, "issue_ms_per_step"),
         window_issue_cpu_ms_per_step=col(windows, "issue_cpu_ms_per_step"),
         window_host_probe_ms=col(windows, "host_probe_ms"),
         plain_sort_step_ms=plain_step[len(plain_step) // 2],
         plain_sort_window_ms_per_step=col(plain_windows, "ms_per_step"),
         plain_sort_window_host_probe_ms=col(plain_windows, "host_probe_ms"),
         nogc_window_ms_per_step=col(nogc, "ms_per_step"),
         nogc_window_host_probe_ms=col(nogc, "host_probe_ms"),
         single_step_ms=col(single, "ms_per_step"),
         single_issue_ms=col(single, "issue_ms_per_step"),
         single_host_probe_ms=col(single, "host_probe_ms"),
         host_syncs_per_step=syncs, loadavg=os.getloadavg(), smi=card)

    # int32 operations a second at the max SM clock (`int_ops_per_s`)
    ops_s = int_ops_per_s(props, sm_clock_mhz)
    Lq = pq.shape[1]
    qrows = torch.clamp(pql, max=Lq).long()
    live_flat = live.reshape(-1)
    live_cells = int((qrows * ptl.long())[live_flat].sum())
    block4 = sw_shape_time(sw_cuda, (pq, pql, pt, ptl), BWA_PARAMS, "local",
                           0, ops_s, live_cells=live_cells)
    block4["plain_ms"] = cuda_ms(lambda: sw_cuda.sw_batch_plain(
        pq, pql, pt, ptl, BWA_PARAMS, "local"), 1)
    # Pick's three kernel calls of the checked run, on their own inputs
    pick = [sw_shape_time(sw_cuda, c[:4], *c[4:], ops_s) for c in pick_sw]
    del pick_sw
    sw_ms, plain_ms = block4["ms"], block4["plain_ms"]
    emit(phase="sw_time", **block4, pick=pick, smi=card)

    sort = sort_times(psort, step)
    emit(phase="sort_time", **sort, smi=card)

    fused.assemble_batch(cfg, batch, per_gap, readsets, R, L, md)
    t = time.perf_counter()
    fused.assemble_batch(cfg, batch, per_gap, readsets, R, L, md)
    asm_ms = (time.perf_counter() - t) * 1e3
    emit(phase="stage_time", assemble_batch_ms=asm_ms,
         assemble_gaps_per_s=len(batch) / (asm_ms / 1e3),
         pick_ms=pick_ms, pick_gaps_per_s=len(batch) /
         (pick_ms["total_ms"] / 1e3), smi=card)

    # per-block breakdown and device busy share of the production step
    block_times(sl, pdims, pin)                          # warm-up
    runs = [block_times(sl, pdims, pin) for _ in range(3)]
    blocks = {k: sorted(r[k] for r in runs)[1] for k in runs[0]}
    emit(phase="step_blocks", **blocks, sum_ms=sum(blocks.values()),
         runs=runs, smi=card)
    # the step's CUDA launches of the hand kernels, by their counters
    # (sort: CUDA launches a call at each shape, `sort_time`)
    hand = {"sort": round(sort["step_cuda_launches"]),
            "sw": launches["step"]["sw"]}
    prof = profile_step(step, hand)
    with patched(psort, "bitonic_sort", psort.bitonic_sort_plain):
        prof_plain = profile_step(step, dict(hand, sort=0))
    emit(phase="step_profile", **prof,
         busy_share=prof["device_busy_ms"] / prof["profiled_wall_ms"],
         plain_sort=prof_plain, smi=card)

    # ---- phase 10: the probes path (the probe scripts of scripts/) ------
    # each probe module's main() on the card, as its JAX script runs
    reset_counts()
    path = {"kernel_experiments": kernel_experiments.main(),
            "swprobe": swprobe.main(verify=True),
            "int16_repro": int16_repro.main()}
    torch.cuda.synchronize()
    launches["probes"] = read_counts()
    idle = [k for k in PROBE_KERNELS if launches["probes"][k] < 1]
    if idle:
        raise AssertionError(f"the probes path did not launch {idle}")
    ke_out = path["kernel_experiments"]
    zeros = torch.zeros((kernel_experiments.S, kernel_experiments.TB),
                        dtype=torch.int32, device=dev)
    if not torch.equal(ke_out["int16_loop"],
                       kernel_experiments.exp_int16_loop_plain(zeros)):
        raise AssertionError("exp_int16_loop on the script's input != plain")
    for g, w in zip(ke_out["int32_argmax"],
                    kernel_experiments.exp_int32_loop_with_argmax_plain(zeros)):
        if not torch.equal(g, w):
            raise AssertionError("exp_int32_loop_with_argmax on the "
                                 "script's input != plain")
    pcheck = check_probes(kernel_experiments, swprobe, int16_repro, dev,
                          FILL_TILES_PER_SM * props.multi_processor_count)
    emit(phase="probe_check", launches=launches["probes"], **pcheck,
         script_outputs_equal_plain=True)
    ptimes = probe_times(kernel_experiments, swprobe, int16_repro, probes,
                         dev, props.multi_processor_count, ops_s)
    emit(phase="probe_time", **ptimes, smi=card)
    emit(phase="probe_sass",
         sass=loop_sass(str(cuda_build._target("probes")), cuda_build._nvcc()),
         ptxas=ptxas_loops(reports["probes"]) if "probes" in reports
         else None)

    # ---- phase 11: the driver path (run_assembly_and_pick) ---------------
    drv = driver_phase(pargs, res[4], dev, ops_s, reset_counts, read_counts)
    launches["driver"] = drv.pop("launches")
    emit(phase="driver", **drv.pop("check"), launches=launches["driver"])
    emit(phase="driver_time", **drv, smi=card)

    with tempfile.TemporaryDirectory() as root:
        # ---- phase 12: the ingest chain (Preprocess -> Collect -> driver
        # -> Patch) on files -----------------------------------------------
        t = time.perf_counter()
        chain = chain_phase(dev, reset_counts, read_counts, root)
        launches["chain"] = chain["launches"]
        emit(phase="chain", **chain["check"], launches=launches["chain"],
             collect_launches=chain["collect_launches"])
        emit(phase="collect_time", **chain["time"],
             phase_s=time.perf_counter() - t, smi=card)

        # ---- phase 13: the CLI on the card, on phase 12's files ----------
        t = time.perf_counter()
        clirun = cli_phase(root, chain, dev, reset_counts, read_counts)
        launches["cli"] = clirun.pop("launches")
        launches["evaluate"] = clirun.pop("evaluate_launches")
        launches["nonfused"] = clirun.pop("nonfused_launches")
        emit(phase="cli", **clirun.pop("check"), launches=launches["cli"],
             evaluate_launches=launches["evaluate"],
             nonfused_launches=launches["nonfused"])
        emit(phase="cli_time", **clirun, phase_s=time.perf_counter() - t,
             smi=card)

        # ---- phase 14: one process, two shards on the one card ---------
        t = time.perf_counter()
        shards = shards_phase(dev, pdims, pin, res, (
            cfg, batch, per_gap, readsets, R, L, md, contigs), reset_counts,
            read_counts)
        launches["shards"] = shards["launches"]
        emit(phase="shards", **shards["check"], launches=launches["shards"])
        emit(phase="shards_time", step_ms=shards["time"],
             issue_ms=shards["issue_ms"], profile=shards["profile"],
             phase_s=time.perf_counter() - t, smi=card)

        # ---- phase 15: two processes on the one card (gloo) ------------
        t = time.perf_counter()
        mproc = multiprocess_phase(root, chain, clirun, shards)
        # rank 0's counts; the ranks launch no probe kernel
        none = {k: 0 for k in launches["shards"]}
        launches["multiprocess"] = dict(none, **mproc["launches"])
        launches["multiprocess_cli"] = dict(none, **mproc["cli_launches"])
        emit(phase="multiprocess", **mproc["check"],
             launches=launches["multiprocess"],
             cli_launches=launches["multiprocess_cli"])
        emit(phase="multiprocess_time", **mproc["time"],
             phase_s=time.perf_counter() - t, smi=card)

    def copy_fields(r):
        """Rows 3 and 7: where bytes set the time, the odd shape, the
        launch floor."""
        if "launch_floor_ms" not in r:
            return {}
        f = r["fill"]
        return {"fill_ms": f["ms"], "fill_device_ms": f["device_ms"],
                "fill_bound_ms": f["bound_ms"],
                "fill_library_ms": f["library_ms"],
                "fill_shape": f["shape"],
                "launch_floor_ms": r["launch_floor_ms"],
                **({"odd_ms": r["odd"]["ms"],
                    "odd_device_ms": r["odd"]["device_ms"],
                    "odd_library_ms": r["odd"]["library_ms"]}
                   if "odd" in r else {})}

    probe_rows = [{
        "name": name, "route": "cuda",
        "source": "gappadder_tpu_torch/csrc/probes.cu", "replaces": where,
        "launches": launches["probes"][key],
        "max_abs_err": float(pcheck["max_abs_err"][key]),
        **{k: ptimes[key][k] for k in ("ms", "device_ms", "plain_ms",
                                       "bound_ms", "bound_by", "library_ms")},
        **copy_fields(ptimes[key]),
        "launches_by_path": {p: v[key] for p, v in launches.items()},
        "check": "exact equality with the plain twin (probe_check line); "
                 "times at the script's shape (probe_time line), where the "
                 "dependent chain of steps (the copies: the launch) sets "
                 "the time far above the throughput bound; rows 4-6 also "
                 "at 4 tiles an SM there, rows 3 and 7 where bytes set "
                 "the time (fill_*) and at an odd shape (odd_*)"}
        for key, (name, where) in PROBE_KERNELS.items()]
    emit(kernels=[{
        "name": "sw_batch_cuda", "route": "cuda",
        "source": "gappadder_tpu_torch/csrc/sw.cu",
        "replaces": "gappadder_tpu/ops/sw_pallas.py:242",
        "launches": launches["step"]["sw"], "max_abs_err": float(max_err),
        "ms": sw_ms, "device_ms": block4["device_ms"], "plain_ms": plain_ms,
        "bound_ms": block4["bound_ms"], "bound_by": block4["bound_by"],
        "library_ms": None, "live_share": block4["live_share"],
        "launches_by_path": {p: v["sw"] for p, v in launches.items()},
        "merge_shapes": drv["sw_merge_shapes"],
        "check": "exact equality with sw_batch_plain, on every call shape "
                 "of the driver path too (Lq > 1024 in strips); times at "
                 "the step's block-4 shape, Pick's in the sw_time line, "
                 "the merge's in the driver_time line"}, {
        "name": "bitonic_sort", "route": "cuda",
        "source": "gappadder_tpu_torch/csrc/sort.cu",
        "replaces": "gappadder_tpu/ops/psort.py:67",
        "launches": launches["step"]["sort"], "max_abs_err": float(sort_err),
        "ms": sort["step_ms"], "device_ms": sort["step_device_ms"],
        "plain_ms": sort["step_plain_ms"],
        "bound_ms": sort["step_bound_ms"], "bound_by": "bytes",
        "library_ms": sort["step_library_ms"],
        "launches_by_path": {p: v["sort"] for p, v in launches.items()},
        "seedmatch_rows": drv["seedmatch_sorts"],
        "collect_shapes": chain["time"]["collect_sorts"],
        "nonfused_merge_shapes": clirun["nonfused_merge_sorts"],
        "check": "exact equality with bitonic_sort_plain in every plane, "
                 "on every call shape of the driver and chain paths too; "
                 "times are the sums over one production step's sort calls "
                 "(sort_time line), the seed matcher's rows in the "
                 "driver_time line, Collect's shapes in the collect_time "
                 "line, the non-fused k-mer merge's in the cli_time "
                 "line"}, *probe_rows])
    print(card, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


def check_closure(contigs, glens, kset):
    """Every gap has, for every (k, sub_k) setting, a contig that spans
    the gap and k bases beside it."""
    for s, (k, sub_k) in enumerate(kset):
        for g, glen in enumerate(glens):
            pre = f"{k}_{sub_k}_"
            lens = [int(contigs.length[g, j])
                    for j, nm in enumerate(contigs.names[g])
                    if nm.startswith(pre)]
            if not lens or max(lens) < glen + k:
                raise AssertionError(f"Assembly batch: setting {s} did not "
                                     f"close gap {g} ({lens} < {glen}+{k})")


class DriverClock:
    """Host-clock ms of the driver's stages and sub-stages (each call
    between two synchronisations of the card, summed by label; an outer
    stage's time includes its sub-stages'), the counts the driver_time
    line reports, and a copy of the inputs of every SW and sort call with
    the label of the stage that made it."""

    def __init__(self):
        self.ms: dict = {}
        self.counts: dict = {}
        self.stack = ["driver"]
        self.round = 0
        self.closed_by: dict = {}
        self.rescued: dict = {}
        self.sw_calls: list = []
        self.sorts: dict = {}

    def add(self, key, n):
        self.counts[key] = self.counts.get(key, 0) + n

    def timed(self, label, inner, after=None):
        def call(*a, **kw):
            lab = label(a, kw) if callable(label) else label
            self.stack.append(lab)
            torch.cuda.synchronize()
            t = time.perf_counter()
            try:
                out = inner(*a, **kw)
            finally:
                torch.cuda.synchronize()
                self.ms[lab] = (self.ms.get(lab, 0.0)
                                + (time.perf_counter() - t) * 1e3)
                self.stack.pop()
            if after is not None:
                after(a, kw, out)
            return out
        return call

    def install(self, stack, run, fused, rescue, seedmatch, merge_engine,
                swutil, psort):
        def wrap(module, name, label, after=None):
            stack.enter_context(patched(module, name, self.timed(
                label, getattr(module, name), after)))

        def asm_label(a, kw):
            self.round += 1
            return f"round{self.round}"

        def refine():
            top = [x for x in self.stack if x.endswith("refine")]
            return top[-1] if top else "refine"

        def ctx():
            return "rescue" if "rescue" in self.stack else "hq"

        def sw_label(a, kw):
            mode = a[2]
            self.add(f"{refine()}_{mode}_pairs", len(a[0]))
            return f"{refine()}_{'overlap' if mode == 'overlap' else 'dedup'}_sw"

        def eval_label(a, kw):
            relax = kw.get("relax", a[2] if len(a) > 2 else False)
            if not relax:
                self.add(f"{refine()}_survivors", len(a[0]))
            return f"{refine()}_{'splice' if relax else 'evaluate_dp'}"

        def pick_label(a, kw):
            ext = kw.get("allow_extension", a[7] if len(a) > 7 else False)
            return "final_pick" if ext else f"round{self.round}_pick"

        def pick_after(a, kw, out):
            fills = a[4]
            lab = pick_label(a, kw)
            done = {g for v in self.closed_by.values() for g in v}
            self.closed_by[lab] = sorted(set(fills) - done)

        def rescue_after(a, kw, out):
            self.rescued = {int(g): len(v) for g, v in out.items()}

        wrap(run, "_assemble_gaps", asm_label)
        wrap(fused, "assemble_batch", lambda a, kw: f"round{self.round}_assembly")
        wrap(run, "refine_contigs_multi",
             lambda a, kw: (f"round{self.round}_refine"
                            if f"round{self.round}" in self.stack
                            else "hq_refine"))
        wrap(merge_engine, "_sw_batch_np", sw_label)
        wrap(merge_engine, "evaluate_pairs", eval_label)
        wrap(merge_engine, "merge_contigs_multi", "merge_graph",
             lambda a, kw, out: self.add(
                 f"{refine()}_merged_paths", sum(len(m) for m, _ in out)))
        wrap(run, "_pick_gaps", pick_label, pick_after)
        wrap(rescue, "rescue_both_unmapped", "rescue", rescue_after)
        wrap(rescue, "hq_pseudo_contigs", "hq",
             lambda a, kw, out: self.add("hq_pseudo_contigs", len(out)))
        wrap(seedmatch, "build_index", lambda a, kw: f"{ctx()}_index")
        wrap(seedmatch, "match_candidates", lambda a, kw: f"{ctx()}_match")
        wrap(seedmatch, "vote_pairs", lambda a, kw: f"{ctx()}_match")
        wrap(rescue, "_verify_hits", lambda a, kw: f"{ctx()}_verify")
        wrap(run, "_write_picked", "writes")
        wrap(run, "_write_merge_info", "writes")

        sw_inner = swutil.sw_batch_cuda

        def sw_record(q, qlen, t, tlen, params, mode="local", end_slack=0):
            self.sw_calls.append((self.stack[-1], (q.clone(), qlen.clone(),
                                  t.clone(), tlen.clone()), params, mode,
                                  end_slack))
            return sw_inner(q, qlen, t, tlen, params, mode, end_slack)
        stack.enter_context(patched(swutil, "sw_batch_cuda", sw_record))

        sort_inner = psort.bitonic_sort

        def sort_record(ops, num_keys, stable=False):
            ops = tuple(ops)
            key = (tuple(ops[0].shape), num_keys, len(ops) - num_keys)
            n, labels, _ = self.sorts.get(key, (0, set(), None))
            self.sorts[key] = (n + 1, labels | {self.stack[-1]},
                               [o.clone() for o in ops])
            return sort_inner(ops, num_keys, stable)
        stack.enter_context(patched(psort, "bitonic_sort", sort_record))


def open_gap_driver(dev, tmp, err_rate: float) -> dict:
    """The open-gap toy driver (`testcases.open_gap_workspace`, reads
    substituted at `err_rate`): the port's Preprocess and Collect, then
    `run_assembly_and_pick` from the workspace's checkpoints, on the
    card and on the CPU. Rescue and round 2 cannot close the gap; the
    relaxed final pick must extend it; with read errors HQ must build a
    pseudo-contig. The card's workspace files, fills, extensions, contig
    stores and pseudo-contigs must equal the CPU's."""
    from gappadder_tpu_torch.pipeline import rescue, run
    from gappadder_tpu_torch.testcases import (open_gap_workspace,
                                               same_workspace)
    outs, built = [], []
    inner = rescue.hq_pseudo_contigs

    def counted(*a, **kw):
        out = inner(*a, **kw)
        built[-1].append([c.tolist() for c in out])
        return out

    for where in (dev, "cpu"):
        built.append([])
        cfg, ws, _truth, _span, kept = open_gap_workspace(
            os.path.join(tmp, f"open_gap_{err_rate}", str(where)),
            err_rate=err_rate, device=where)
        with patched(rescue, "hq_pseudo_contigs", counted):
            outs.append((ws, run.run_assembly_and_pick(cfg, ws,
                                                       device=where)))
    (ws, got), (cws, want) = outs
    same_workspace(ws.root, cws.root, ("gaps.npz", "recruits.npz",
                                       "both_unmapped.npz") + DRIVER_FILES)
    if plain_values(got) != plain_values(want) or built[0] != built[1]:
        raise AssertionError(f"open-gap driver ({err_rate}): card != CPU")
    fills, exts, _store = got
    if fills or 0 not in exts or len(exts[0][0]) < 1:
        raise AssertionError(f"open-gap driver ({err_rate}): fills "
                             f"{list(fills)}, extensions {list(exts)}")
    pseudo = sum(len(b) for b in built[0])
    if err_rate and pseudo < 1:
        raise AssertionError(f"open-gap driver ({err_rate}): HQ built no "
                             "pseudo-contig on the card")
    return {"equal_cpu": True, "read_error_rate": err_rate,
            "extended_bases": len(exts[0][0]), "both_unmapped_kept": kept,
            "hq_calls": len(built[0]), "hq_pseudo_contigs": pseudo}


def plain_values(x):
    """Nested dicts, tuples and arrays as plain Python values."""
    if isinstance(x, dict):
        return {k: plain_values(v) for k, v in x.items()}
    if isinstance(x, (tuple, list)):
        return [plain_values(v) for v in x]
    if isinstance(x, np.ndarray):
        return (x.dtype.str, x.tolist())
    return x


def driver_phase(pargs, rowtab, dev, ops_s, reset_counts,
                 read_counts) -> dict:
    """Phase 11, the driver path. The toy workspaces on the card against
    the port's CPU run; the production scenario (the step's recruits,
    the inside reads of the 8 gaps nearest 250 bp held back) through
    `run_assembly_and_pick` on the card with the kernel counts reset
    before it and read after, every gap filled with its planted bases;
    then every SW and sort call shape of that run held to the plain
    version on its own inputs, and the kernels timed at the merge's SW
    shapes and the seed matcher's sort rows. Returns the driver_time
    record with "check" (the driver line) and "launches" in it."""
    import tempfile
    from gappadder_tpu_torch.config import Config
    from gappadder_tpu_torch.ops import (merge_engine, psort, seedmatch,
                                         sw_cuda, swutil)
    from gappadder_tpu_torch.parallel import slice as sl
    from gappadder_tpu_torch.pipeline import fused, rescue, run
    from gappadder_tpu_torch.testcases import (OPEN_GAP_READ_ERRORS,
                                               driver_workspace,
                                               same_workspace)

    check: dict = {"toy": {}}
    with tempfile.TemporaryDirectory() as tmp:
        # toy scenarios: the card's run == the port's CPU run, byte for byte
        for name, (kw, hold) in TOY_DRIVERS.items():
            dims, args = sl.example_data(1, gaps_per_shard=3, kset=TOY_KSET,
                                         **kw)
            trow = sl.run_step(dims, args, device="cpu")[4].numpy()
            cfg = Config(draft_genome="draft.fa", kmers=TOY_KSET)
            outs = []
            for where in (dev, "cpu"):
                ws, rec, rs, fills, held = driver_workspace(
                    os.path.join(tmp, name, str(where)), args, trow, hold)
                outs.append((ws, run.run_assembly_and_pick(
                    cfg, ws, rec, rs, device=where)))
            (ws, got), (cws, want) = outs
            same_workspace(ws.root, cws.root, DRIVER_FILES)
            if plain_values(got) != plain_values(want):
                raise AssertionError(f"toy driver {name}: card != CPU")
            if sorted(got[0]) != [0, 1, 2] or any(
                    not np.array_equal(got[0][g][0], fills[g]) for g in got[0]):
                raise AssertionError(f"toy driver {name} did not fill every "
                                     "gap with the planted bases")
            check["toy"][name] = {"equal_cpu": True, "filled": len(got[0]),
                                  "held_back_reads": held}
        for err_rate in (0.0, OPEN_GAP_READ_ERRORS):
            check["toy"][f"open_gap_{err_rate}"] = open_gap_driver(
                dev, tmp, err_rate)

        # production: the 8 gaps nearest 250 bp need rescue and round 2
        glens = np.asarray(pargs[17]) - np.asarray(pargs[16])
        hold = [int(g) for g in np.argsort(np.abs(glens - HELD_BACK_NEAR),
                                           kind="stable")[:HELD_BACK_GAPS]]
        ws, rec, rs, truth, held = driver_workspace(
            os.path.join(tmp, "production"), pargs, rowtab, hold)
        cfg = Config(draft_genome="draft.fa", kmers=PRODUCTION_KSET)
        clock = DriverClock()
        reset_counts()
        with contextlib.ExitStack() as stack:
            clock.install(stack, run, fused, rescue, seedmatch, merge_engine,
                          swutil, psort)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            fills, exts, store = run.run_assembly_and_pick(cfg, ws, rec, rs,
                                                           device=dev)
            torch.cuda.synchronize()
            total_ms = (time.perf_counter() - t0) * 1e3
        launches = read_counts()
        if min(launches["sw"], launches["sort"]) < 1:
            raise AssertionError(f"driver path launches {launches}")
        missing = [g for g in range(len(glens)) if g not in fills]
        wrong = [g for g in fills if not np.array_equal(fills[g][0],
                                                        truth[g])]
        if missing or wrong:
            raise AssertionError(f"production driver: gaps {missing} "
                                 f"unfilled, {wrong} not the planted bases")
        late = clock.closed_by.get("round2_pick", [])
        if sorted(late) != sorted(hold) or any(
                clock.rescued.get(g, 0) < 1 for g in hold):
            raise AssertionError(f"held-back gaps {hold}: rescued "
                                 f"{clock.rescued}, closed by "
                                 f"{clock.closed_by}")

    sw_keys, held_sw, held_sort = hold_driver_calls(clock, dev)
    if not any(qs[1] > sw_cuda.STRIP_ROWS for _, qs, _, _, _ in sw_keys):
        raise AssertionError("the driver made no SW call with Lq > 1024")
    check.update(n_gaps=len(glens), filled=len(fills), extended=len(exts),
                 equal_planted=True, held_back=hold,
                 held_back_reads={str(g): held.get(g, 0) for g in hold},
                 rescued_reads={str(g): n for g, n in clock.rescued.items()},
                 closed_by=clock.closed_by,
                 sw_shapes_equal_plain=held_sw,
                 sort_shapes_equal_plain=held_sort)

    # the SW kernel at the merge's and rescue's shapes; every call by mode
    merge_shapes, by_mode = [], {}
    for (mode, qs, ts, params, slack), (n, labs, args) in sw_keys.items():
        r = sw_shape_time(sw_cuda, args, params, mode, slack, ops_s)
        r.update(calls=n, stages=sorted(labs), strips=sw_cuda.strips(qs[1]))
        m = by_mode.setdefault(mode, {"calls": 0, "kernel_ms": 0.0,
                                      "live_cells": 0})
        m["calls"] += n
        m["kernel_ms"] += n * r["ms"]
        m["live_cells"] += n * r["live_cells"]
        if any(x.endswith("_sw") or x.startswith(("rescue", "hq"))
               for x in labs):
            merge_shapes.append(r)
    for m in by_mode.values():
        m["gcups_live"] = m["live_cells"] / (m["kernel_ms"] / 1e3) / 1e9
    # the seed matcher's sort rows
    seed_sorts = []
    for (shape, nk, npay), (n, labs, ops) in sorted(clock.sorts.items()):
        if not any(x.endswith(("_index", "_match")) for x in labs):
            continue
        fn = lambda: psort.bitonic_sort(ops, nk)
        fn()
        elems = int(np.prod(shape))
        seed_sorts.append({
            "shape": list(shape), "keys": nk, "payloads": npay, "calls": n,
            "stages": sorted(labs), "ms": cuda_ms(fn, 10),
            "device_ms": kernel_profile(fn, 5, "psort_")[0] / 5,
            "plain_ms": cuda_ms(lambda: psort.bitonic_sort_plain(ops, nk), 5),
            "bound_ms": 2 * 8 * elems * (nk + npay) / HBM_BYTES_PER_S * 1e3})
    refine = {}
    for r in sorted({k.split("_")[0] for k in clock.ms
                     if k.endswith("refine")} | {"hq"}):
        tot = clock.ms.get(f"{r}_refine", 0.0)
        if not tot:
            continue
        part = {x: clock.ms.get(f"{r}_refine_{x}", 0.0)
                for x in ("dedup_sw", "overlap_sw", "evaluate_dp", "splice")}
        refine[r] = dict(part, total_ms=tot,
                         evaluate_dp_share=(part["evaluate_dp"]
                                            + part["splice"]) / tot)
    return {"check": check, "launches": launches, "total_ms": total_ms,
            "stage_ms": clock.ms, "refine": refine, "counts": clock.counts,
            "sw_by_mode": by_mode, "sw_merge_shapes": merge_shapes,
            "seedmatch_sorts": seed_sorts}


def install_collect_clock(clock, stack, ws, collect, preprocess, gapscan,
                          fastq, recruit, counts):
    """Time Collect's parts on the DriverClock `clock` (host ms between
    two synchronisations of the card) and count what they see: records
    decoded, focal candidates, the clip / disc / unmap hits of pass 1,
    pass 2's entries."""
    from gappadder_tpu_torch.parallel import mp

    def wrap(module, name, label, after=None):
        stack.enter_context(patched(module, name, clock.timed(
            label, getattr(module, name), after)))

    def add(key, n):
        counts[key] = counts.get(key, 0) + int(n)

    wrap(preprocess, "run_preprocess", "preprocess")
    wrap(gapscan, "scan_genome", "preprocess_scan")
    wrap(collect, "read_bam_any", "bam_decode",
         lambda a, kw, out: add("records", out.n))
    wrap(fastq, "scan_fastq", "fastq_scan",
         lambda a, kw, out: add("fastq_reads", out.n))
    wrap(collect, "_focal_candidate_rows", "focal_prefilter",
         lambda a, kw, out: add("pass1_records", len(out)))
    wrap(collect, "_pass1", "pass1")
    wrap(collect, "_pass2", "pass2")
    wrap(recruit, "recruit_on_device", "union")
    wrap(collect, "_both_unmapped_rows", "both_unmapped")
    wrap(collect, "_write_gap_fastqs", "gap_fastqs")
    stack.enter_context(patched(ws, "save_arrays", clock.timed(
        lambda a, kw: ("preprocess_npz" if "preprocess" in clock.stack
                       else "npz_writes"), ws.save_arrays)))
    step, low = collect.make_extract_step, collect._lowmapq_compact

    def make(dims, mesh, ecap=1 << 15):
        fn = step(dims, mesh, ecap)

        def counted(mat, *windows):
            packed, c3 = fn(mat, *windows)
            # each shard's three counts, summed over the shards
            for k, v in zip(("clip", "disc", "unmap"),
                            mp.to_np(c3).reshape(-1, 3).sum(0).tolist()):
                add(k, v)
            return packed, c3
        return counted

    def low_counted(mat, windows, *, fanout, ecap):
        out = low(mat, windows, fanout=fanout, ecap=ecap)
        add("pass2_entries", min(int(out[0, 0]), ecap))
        return out
    stack.enter_context(patched(collect, "make_extract_step", make))
    stack.enter_context(patched(collect, "_lowmapq_compact", low_counted))


def chain_phase(dev, reset_counts, read_counts, tmp) -> dict:
    """Phase 12, the ingest chain: `testcases.collect_scenario` at its
    full size (4.6 Mbp draft, 64 gaps, 4 of them open; a paired-end
    library at 30x and a mate-pair one at 5x) written as files, then
    Preprocess -> Collect -> the two-round driver -> Patch on the card,
    with the kernel counts reset before and read after. Preprocess and
    Collect equal the port's CPU run on the same files; every sort call
    shape of Collect and every SW and sort call shape of the driver are
    held to the plain versions on their own inputs; every classification
    branch has work; the fills are the planted bases, the open gaps end
    as extensions or unfilled, and filled_scaffolds.fa is the truth over
    every filled gap and N over every other. The scenario and both
    workspaces stay under `tmp` (phase 13 runs the CLI on them). Returns
    {"check", "time", "launches", "collect_launches", "cfg", "truth"}."""
    from gappadder_tpu_torch.io import fasta, fastq, native
    from gappadder_tpu_torch.ops import (gapscan, merge_engine, psort,
                                         recruit, seedmatch, swutil)
    from gappadder_tpu_torch.pipeline import (collect, fused, patch,
                                              preprocess, rescue, run)
    from gappadder_tpu_torch.pipeline.workspace import Workspace
    from gappadder_tpu_torch.testcases import collect_scenario, same_workspace

    t = time.perf_counter()
    cfg, truth = collect_scenario(os.path.join(tmp, "scenario"), seed=0)
    sim_ms = (time.perf_counter() - t) * 1e3
    # mesh [2]: one process on one card holds one shard, so the chain
    # runs unsharded here and in phase 13; phase 15's two processes run
    # the same config (and config hash) split over the mesh
    cfg = dataclasses.replace(cfg, tpu=dataclasses.replace(
        cfg.tpu, mesh_shape=(2,)))
    cfgs = {w: dataclasses.replace(cfg, working_folder=os.path.join(
        tmp, w)) for w in ("card", "cpu")}
    ws = Workspace(cfgs["card"].workdir)
    clock, counts = DriverClock(), {}
    reset_counts()
    with contextlib.ExitStack() as stack:
        install_collect_clock(clock, stack, ws, collect, preprocess,
                              gapscan, fastq, recruit, counts)
        collect_sorts = stack.enter_context(recording_sorts(psort))
        torch.cuda.synchronize()
        t = time.perf_counter()
        preprocess.run_preprocess(cfgs["card"], ws,
                                  write_parity_files=True, device=dev)
        collect.run_collect(cfgs["card"], ws, write_parity_files=True,
                            device=dev)
        torch.cuda.synchronize()
        ingest_ms = (time.perf_counter() - t) * 1e3
    collect_launches = read_counts()
    ingest = dict(clock.ms)

    # the driver and Patch on the card, from the workspace's files
    dclock = DriverClock()
    with contextlib.ExitStack() as stack:
        dclock.install(stack, run, fused, rescue, seedmatch, merge_engine,
                       swutil, psort)
        torch.cuda.synchronize()
        t = time.perf_counter()
        fills, exts, _store = run.run_assembly_and_pick(
            cfgs["card"], ws, device=dev)
        torch.cuda.synchronize()
        driver_ms = (time.perf_counter() - t) * 1e3
    t = time.perf_counter()
    n_patched = patch.run_patch(cfgs["card"], ws)
    patch_ms = (time.perf_counter() - t) * 1e3
    launches = read_counts()
    if min(launches["sw"], launches["sort"]) < 1 or \
            collect_launches["sort"] < 1:
        raise AssertionError(f"the chain launched {launches}, Collect "
                             f"{collect_launches}")

    # Preprocess and Collect: the card == the port's CPU run
    cws = Workspace(cfgs["cpu"].workdir)
    t = time.perf_counter()
    preprocess.run_preprocess(cfgs["cpu"], cws, write_parity_files=True,
                              device="cpu")
    collect.run_collect(cfgs["cpu"], cws, write_parity_files=True,
                        device="cpu")
    cpu_ingest_ms = (time.perf_counter() - t) * 1e3
    files = same_workspace(ws.root, cws.root, (
        "gaps.npz", "recruits.npz", "both_unmapped.npz", "gap_positions.txt",
        "flank_regions", os.path.join("merged", "gap_reads"),
        os.path.join("merged", "gap_reads_high_quality")))
    # the draft's .fai beside (not in) the workspaces, which phase 13
    # compares file for file with the CLI's
    fais = [os.path.join(tmp, f"draft_{w}.fa.fai") for w in ("card", "cpu")]
    for f in fais:
        fasta.write_fai(cfg.draft_genome, f)
    with open(fais[0], "rb") as a, open(fais[1], "rb") as b:
        if a.read() != b.read():
            raise AssertionError("draft.fa.fai differs card vs CPU")
    bu = len(ws.load_arrays("both_unmapped")["row"])
    n_rec = len(ws.load_arrays("recruits")["gap"])

    # every branch has work
    branches = {k: counts.get(k, 0) for k in ("clip", "disc", "unmap",
                                              "pass2_entries")}
    branches["both_unmapped_rows"] = bu
    if min(branches.values()) < 1:
        raise AssertionError(f"a classification branch is empty: "
                             f"{branches}")

    # fills, extensions and the patched scaffolds against the truth
    gaps, margin = truth["gaps"], truth["margin"]
    planted = [truth["scaffolds"][s][a - margin:b + margin]
               for s, a, b in gaps]
    wrong = [g for g in fills if not np.array_equal(fills[g][0],
                                                    planted[g])]
    opened = [g for g in truth["open"] if g in fills]
    if wrong or opened:
        raise AssertionError(f"chain: gaps {wrong} filled with other "
                             f"than the planted bases, open gaps "
                             f"{opened} filled")
    closed = [g for g in range(len(gaps)) if g not in truth["open"]]
    short = [g for g in closed if g not in fills]
    for stage in ("hq", "final_pick"):
        if stage not in dclock.ms:
            raise AssertionError(f"the chain did not run {stage}")
    if n_patched != len(fills):
        raise AssertionError(f"Patch filled {n_patched} gaps, the "
                             f"driver {len(fills)}")
    out = fasta.read_fasta(ws.path("filled_scaffolds.fa"))
    for si, seq in enumerate(truth["scaffolds"]):
        want = seq.copy()
        for g in np.flatnonzero(gaps[:, 0] == si):
            if g not in fills:
                want[gaps[g, 1]:gaps[g, 2]] = 4          # N
        if not np.array_equal(out.scaffold(si), want):
            raise AssertionError(f"filled_scaffolds.fa: scaffold {si} "
                                 "is not the truth over its fills")
    per_gap = ws.load_arrays("recruits")["gap"]
    shortfall = {str(g): {"gap_len": int(gaps[g, 2] - gaps[g, 1]),
                          "recruits": int((per_gap == g).sum()),
                          "rescued": dclock.rescued.get(g, 0),
                          "extended": g in exts} for g in short}
    sw_keys, held_sw, held_sort = hold_driver_calls(dclock, dev)
    held_collect = []
    for (shape, nk, npay), (n, ops) in sorted(collect_sorts.items()):
        check_sort(psort, ops, nk)
        held_collect.append([list(shape), nk, npay, n])
    sort_rows = sort_shape_times(psort, collect_sorts)
    del collect_sorts, sw_keys
    pass1_s = ingest.get("pass1", 0.0) / 1e3
    check = {
        "n_gaps": len(gaps), "open": truth["open"], "pairs": truth["pairs"],
        "records": counts.get("records", 0), "recruits": n_rec,
        "native_io": native.source(),
        "card_equal_cpu": {"npz": ["gaps", "recruits", "both_unmapped"],
                           "files": len(files)},
        "branches": branches,
        "filled": len(fills), "filled_planted": len(fills),
        "closable": len(closed), "unfilled_closable": short,
        "shortfall": shortfall, "extended": sorted(exts),
        "open_extended": [g for g in truth["open"] if g in exts],
        "closed_by": dclock.closed_by,
        "rescued_reads": {str(g): n for g, n in dclock.rescued.items()},
        "hq_pseudo_contigs": dclock.counts.get("hq_pseudo_contigs", 0),
        "filled_scaffolds_equal_truth": True,
        "sha256": {f: sha256(ws.path(f))
                   for f in DRIVER_FILES + ("filled_scaffolds.fa",)},
        "collect_sort_shapes_equal_plain": held_collect,
        "driver_sw_shapes_equal_plain": held_sw,
        "driver_sort_shapes_equal_plain": held_sort}
    timing = {
        "simulate_ms": sim_ms, "ingest_ms": ingest_ms,
        "preprocess_ms": ingest.get("preprocess", 0.0),
        "preprocess_scan_ms": ingest.get("preprocess_scan", 0.0),
        "collect_ms": {k: ingest.get(k, 0.0) for k in (
            "bam_decode", "fastq_scan", "focal_prefilter", "pass1", "pass2",
            "union", "both_unmapped", "npz_writes", "gap_fastqs")},
        "collect_total_ms": ingest_ms - ingest.get("preprocess", 0.0),
        "cpu_ingest_ms": cpu_ingest_ms,
        "pass1_records": counts.get("pass1_records", 0),
        "pass1_records_per_s": counts.get("pass1_records", 0) / pass1_s
        if pass1_s else None,
        "driver_ms": driver_ms, "driver_stage_ms": dclock.ms,
        "driver_counts": dclock.counts,
        "patch_ms": patch_ms, "collect_sorts": sort_rows}
    return {"check": check, "time": timing, "launches": launches,
            "collect_launches": collect_launches, "cfg": cfgs["card"],
            "truth": truth}


def sha256(path) -> str:
    import hashlib
    with open(path, "rb") as fh:
        return hashlib.sha256(fh.read()).hexdigest()


def trace_mentions(path, words, chunk=1 << 24) -> dict:
    """How often each word occurs in a (Chrome trace) file, read in
    chunks: the trace of a whole driver run is too large to parse."""
    hits = {w: 0 for w in words}
    keep = max(len(w) for w in words) - 1
    tail = b""
    with open(path, "rb") as fh:
        while True:
            block = fh.read(chunk)
            if not block:
                break
            buf = tail + block
            for w in words:
                # count matches that end inside the new block only
                hits[w] += buf.count(w.encode()) - tail.count(w.encode())
            tail = buf[-keep:]
    return hits


def cli_phase(root, chain, dev, reset_counts, read_counts) -> dict:
    """Phase 13, the CLI on the card, on phase 12's scenario files.
    Phase 12's workspace moves aside and the CLI (`cli.main`, in this
    process) takes its path, so the config and its hash are the same:
    (a) `-c All --parity-files` writes the same workspace, file for file
    (the .npz files array by array, the manifest but for its times,
    metrics.json left out), with the kernel counts reset before and read
    after; (b) `-c All` again finds every stage up to date; (c) `-c
    Evaluate --finished` on the planted genome, counts reset before and
    read after, under the recording hooks, hits every closable gap, and
    every SW call shape it made equals the plain version; then
    Evaluate's full-DP fallback places a lone flank on a scaffold of
    2^20 bases where the planted bases are (its plain version, one
    tensor step an anti-diagonal, would take 2^20 of them); (d) `-c Assembly --force --trace` names the SW and sort
    kernels in its trace and writes the same files; (e) the driver with
    tpu.fused=False, counts reset before and read after, under phase
    11's recording hooks: every SW and sort call shape equals the plain
    version, its picked_seqs.fa, _ori.txt and merge_info.txt equal the
    fused run's, and the k-mer merge's sort shapes are timed; (f)
    `refiner.classify_repeat` and `scaffold.build_scaffolds` on round 1's
    contigs of four gaps, on the card, equal the CPU run. Returns the
    cli_time record with "check", "launches", "evaluate_launches" and
    "nonfused_launches" in it."""
    import io
    import shutil
    from gappadder_tpu_torch import cli, dna
    from gappadder_tpu_torch.io import fasta
    from gappadder_tpu_torch.ops import (merge_engine, minimap, psort,
                                         seedmatch, sw_cuda, swutil)
    from gappadder_tpu_torch.pipeline import (assemble, fused, rescue,
                                              run)
    from gappadder_tpu_torch.pipeline.preprocess import gap_ids
    from gappadder_tpu_torch.pipeline.workspace import Workspace
    from gappadder_tpu_torch.testcases import config_dict, same_workspace
    from gappadder_tpu_torch.tools import evaluate, refiner, scaffold
    from gappadder_tpu_torch.utils import meters

    cfg, truth = chain["cfg"], chain["truth"]
    work = cfg.workdir.rstrip("/")
    direct = os.path.join(root, "chain_direct")
    shutil.move(work, direct)
    cfg_path = os.path.join(root, "config.json")
    with open(cfg_path, "w") as fh:
        json.dump(config_dict(cfg), fh)
    metrics = os.path.join(work, "metrics.json")

    def cli_run(*argv):
        """cli.main on the config; returns (printed lines, wall s,
        metrics.json's stages of this run)."""
        meters.GLOBAL.stages.clear()
        out = io.StringIO()
        torch.cuda.synchronize()
        t = time.perf_counter()
        with contextlib.redirect_stdout(out):
            rc = cli.main(["-g", cfg_path, *argv])
        torch.cuda.synchronize()
        wall = time.perf_counter() - t
        if rc != 0:
            raise AssertionError(f"cli {argv} exited {rc}")
        with open(metrics) as fh:
            stages = json.load(fh)["stages"]
        return out.getvalue().splitlines(), wall, stages

    # (a) -c All: the same workspace as phase 12's direct calls
    reset_counts()
    printed_all, all_s, all_stages = cli_run("-c", "All", "--parity-files")
    launches = read_counts()
    if min(launches["sw"], launches["sort"]) < 1:
        raise AssertionError(f"the CLI launched {launches}")
    files = same_workspace(direct, work)

    # (b) -c All again: every stage up to date
    printed_again, again_s, _ = cli_run("-c", "All")
    if sum("up-to-date" in ln for ln in printed_again) != 3:
        raise AssertionError(f"-c All again printed {printed_again}")

    # (c) -c Evaluate on the planted genome
    truth_fa = os.path.join(root, "truth.fa")
    fasta.write_fasta(truth_fa, [(f"scaffold_{i}", s)
                                 for i, s in enumerate(truth["scaffolds"])])
    ev_clock = DriverClock()
    reset_counts()
    with contextlib.ExitStack() as stack:
        ev_clock.install(stack, run, fused, rescue, seedmatch, merge_engine,
                         swutil, psort)
        for module, name, lab in (
                (minimap, "build_index", "minimizer_index"),
                (minimap, "map_reads", "map_flanks"),
                (swutil, "sw_pairs", "sw"),
                (swutil, "sw_small", "sw"),
                (evaluate, "alignment_stats", "host_traceback")):
            stack.enter_context(patched(module, name, ev_clock.timed(
                lab, getattr(module, name))))
        printed_ev, ev_s, ev_stages = cli_run("-c", "Evaluate",
                                              "--finished", truth_fa)
    ev_launches = read_counts()
    if ev_launches["sw"] < 1:
        raise AssertionError(f"Evaluate launched {ev_launches}")
    _, ev_held_sw, ev_held_sort = hold_driver_calls(ev_clock, dev)
    ws = Workspace(work)
    ids = gap_ids(ws.load_arrays("gaps"))
    want = [ids[g] for g in range(len(ids)) if g not in truth["open"]]
    with open(ws.path("hit_list.txt")) as fh:
        hits = fh.read().split()
    if hits != want:
        raise AssertionError(f"Evaluate hit {len(hits)} gaps, not the "
                             f"{len(want)} closable ones")
    with open(ws.path("closed_gap_length.txt")) as fh:
        closed_sum = sum(int(x) for x in fh.read().split())
    # the full-DP fallback's largest case: one flank against a scaffold
    # of 2^20 bases, both strands, one pair a kernel call
    big = np.concatenate(truth["scaffolds"][:2])[:1 << 20]
    genome = fasta.Genome(seq=big, offsets=np.array([0]),
                          lengths=np.array([len(big)]), names=["big"])
    torch.cuda.synchronize()
    t = time.perf_counter()
    place = evaluate._best_placement(big[3000:3300], genome, device=dev)
    torch.cuda.synchronize()
    fallback_ms = (time.perf_counter() - t) * 1e3
    if place != (0, 0, 3000, 3300, 0, 300, 300):
        raise AssertionError(f"fallback placement {place}")

    # (d) -c Assembly --force --trace
    trace_dir = os.path.join(root, "trace")
    _, trace_s, trace_stages = cli_run("-c", "Assembly", "--force",
                                       "--trace", trace_dir)
    trace_path = os.path.join(trace_dir, meters.TRACE_FILE)
    traced = trace_mentions(trace_path, ("sw_kernel", "psort_tiles",
                                         "psort_merge"))
    if not traced["sw_kernel"] or not (traced["psort_tiles"]
                                       or traced["psort_merge"]):
        raise AssertionError(f"the trace names {traced}")
    same_workspace(direct, work, DRIVER_FILES)

    # (e) the non-fused batch under the recording hooks
    nf_dir = os.path.join(root, "nonfused")
    shutil.copytree(work, nf_dir)
    nf_cfg = dataclasses.replace(
        cfg, working_folder=nf_dir,
        tpu=dataclasses.replace(cfg.tpu, fused=False))
    clock = DriverClock()
    reset_counts()
    with contextlib.ExitStack() as stack:
        clock.install(stack, run, fused, rescue, seedmatch, merge_engine,
                      swutil, psort)
        for name, lab in (("assemble_gap_batch", "assembly"),
                          ("_merge_chunk_impl", "kmer_merge")):
            stack.enter_context(patched(assemble, name, clock.timed(
                lambda a, kw, lab=lab: f"round{clock.round}_{lab}",
                getattr(assemble, name))))
        torch.cuda.synchronize()
        t = time.perf_counter()
        fills, _exts, store = run.run_assembly_and_pick(
            nf_cfg, Workspace(nf_dir), device=dev)
        torch.cuda.synchronize()
        nf_ms = (time.perf_counter() - t) * 1e3
    nf_launches = read_counts()
    if min(nf_launches["sw"], nf_launches["sort"]) < 1:
        raise AssertionError(f"the non-fused driver launched {nf_launches}")
    same_workspace(nf_dir, work, DRIVER_FILES)
    merge_calls = {key: [n, ops] for key, (n, labs, ops)
                   in clock.sorts.items()
                   if any(x.endswith("kmer_merge") for x in labs)}
    if not merge_calls:
        raise AssertionError("the non-fused k-mer merge made no sort call")
    _sw_keys, held_sw, held_sort = hold_driver_calls(clock, dev)
    merge_rows = sort_shape_times(psort, merge_calls)
    del merge_calls, _sw_keys

    # (f) the tools on round 1's contigs of four gaps, card == CPU
    gl = clock.closed_by.get("round1_pick", [])[:4]
    if len(gl) < 4:
        raise AssertionError(f"round 1 closed {gl}")
    cs = []
    for g in gl:
        s, ln, _n, nm = store[g]
        i = nm.index(fills[g][1])
        cs.append(np.asarray(s[i][:int(ln[i])]))
    a, b = int(len(cs[2]) * 0.6), int(len(cs[2]) * 0.4)
    parts = [cs[0], cs[1], cs[2][:a], cs[2][b:]]
    pnames = ["g0", "g1", "g2a", "g2b"]

    def link(i, j, d2, dist):
        return (i, pnames[i], len(parts[i]), "+", j, pnames[j],
                len(parts[j]), d2, 9, float(dist), float(dist), float(dist))
    links = [link(0, 1, "+", 80), link(2, 3, "+", b - a),
             link(1, 2, "-", -40), link(3, 0, "+", 20)]
    pairs = [(cs[0], cs[0]), (cs[0], dna.revcomp(cs[0])), (cs[0], cs[1]),
             (cs[3][:200], cs[3])]
    sws = sw_cuda.launches
    tools = {}
    for where in (dev, "cpu"):
        tools[str(where)] = plain_values([
            [refiner.classify_repeat(x, y, device=where) for x, y in pairs],
            scaffold.build_scaffolds(parts, pnames, links, chain=True,
                                     device=where)])
    tool_launches = sw_cuda.launches - sws
    card_tools, cpu_tools = tools[str(dev)], tools["cpu"]
    if card_tools != cpu_tools:
        raise AssertionError("tools: the card's results != the CPU's")
    if tool_launches < len(pairs) + 1:
        raise AssertionError(f"tools: {tool_launches} kernel launches")
    recs = card_tools[1][0]
    if [r[0] for r in card_tools[0][:2]] != ["forward", "reverse"] or \
            not any(r[1] == plain_values(cs[2]) for r in recs):
        raise AssertionError("tools: repeat classes or the overlap merge "
                             f"are wrong: {[r[0] for r in recs]}")

    check = {
        "all": {"printed": printed_all, "equal_direct_workspace": True,
                "files": len(files)},
        "again_up_to_date": 3,
        "evaluate": {"printed": printed_ev, "hits": len(hits),
                     "closable": len(want), "closed_length_sum": closed_sum,
                     "sw_shapes_equal_plain": ev_held_sw,
                     "sort_shapes_equal_plain": ev_held_sort,
                     "fallback_placement_2pow20": list(place)},
        "trace": {"kernels": traced,
                  "mb": os.path.getsize(trace_path) / 2 ** 20},
        "nonfused": {"filled": len(fills), "equal_fused_files": True,
                     "sw_shapes_equal_plain": held_sw,
                     "sort_shapes_equal_plain": held_sort},
        "tools": {"gaps": [int(g) for g in gl], "equal_cpu": True,
                  "classes": [r[0] for r in card_tools[0]],
                  "scaffold_records": [r[0] for r in recs],
                  "sw_launches": tool_launches}}
    return {"check": check, "launches": launches,
            "evaluate_launches": ev_launches,
            "nonfused_launches": nf_launches,
            "all_s": all_s, "stage_s": {k: v["seconds"]
                                        for k, v in all_stages.items()},
            "again_s": again_s, "evaluate_ms": ev_stages["evaluate"]
            ["seconds"] * 1e3, "evaluate_cli_s": ev_s,
            "evaluate_parts_ms": ev_clock.ms,
            "fallback_2pow20_ms": fallback_ms,
            "traced_assembly_s": trace_stages["assembly"]["seconds"],
            "fused_driver_ms": {
                "cli_assembly": all_stages["assembly"]["seconds"] * 1e3,
                "phase12_hooked": chain["time"]["driver_ms"]},
            "nonfused_driver_ms": nf_ms, "nonfused_stage_ms": clock.ms,
            "nonfused_merge_sorts": merge_rows}


def shards_phase(dev, pdims, pin, res, asm, reset_counts,
                 read_counts) -> dict:
    """Phase 14, one process with two shards on the one card: the
    production step through `make_slice_step` over
    `make_mesh(devices=[dev, dev])` (64 gaps, 32 a shard) and the
    production Assembly batch over the same mesh, the kernel counts
    reset before and read after both. Every per-gap output of the step
    (row shard * 32 + slot of gap shard + 2 * slot, `home_of`) equals
    phase 5's one-shard step's, counts[:7], hist and the total received
    entries too, and counts[7] (a shard's largest router demand) times
    2 is at least phase 5's; the batch equals phase 7's; every SW and
    sort call shape of both runs equals the plain version on its own
    inputs. Then the 2-shard step and phase 5's step by CUDA events in
    turns (one, two, two, one) and one profiled 2-shard step. `asm` is
    phase 7's (cfg, batch, per_gap, readsets, R, L, md, contigs)."""
    from gappadder_tpu_torch.ops import psort, sw_cuda
    from gappadder_tpu_torch.parallel import mesh as pmesh, mp
    from gappadder_tpu_torch.parallel import slice as sl
    from gappadder_tpu_torch.parallel.mp_slice_worker import summarize
    from gappadder_tpu_torch.pipeline import fused
    cfg, batch, per_gap, readsets, R, L, md, contigs = asm
    N = 2
    mesh = pmesh.make_mesh(shape=(N,), axes=("dp",), devices=[dev, dev])
    dims, args = sl.example_data(N, **dict(
        PRODUCTION, gaps_per_shard=PRODUCTION["gaps_per_shard"] // N))
    step = sl.make_slice_step(mesh, dims)
    placed = sl.place_args(mesh, args)
    reset_counts()
    with recording_sorts(psort) as sorts, recording_sw(sl) as sws:
        out = [mp.to_np(o) for o in step(*placed)]
        contigs2 = fused.assemble_batch(cfg, batch, per_gap, readsets, R, L,
                                        md, device=dev, mesh=mesh)
        torch.cuda.synchronize()
    launches = read_counts()
    if min(launches["sw"], launches["sort"]) < 1:
        raise AssertionError(f"the 2-shard path launched {launches}")
    counts = out[0]
    sl.check_overflow(dims, counts)
    if counts[:7].tolist() != res[0][:7].tolist() or \
            counts[7] * N < res[0][7] or \
            not np.array_equal(out[1], res[1]) or \
            out[2].sum() != res[2].sum():
        raise AssertionError(f"2-shard step: counts {counts.tolist()} / "
                             f"{res[0].tolist()}, hist or n_recv differ")
    shard, slot = sl.home_of(np.arange(dims.n_gaps), N)
    rows = shard * dims.gaps_per_shard + slot
    names = ("counts", "hist", "n_recv", "n_reads", "rowtab", "hqtab",
             "useq", "ulen", "ucnt", "score", "qend", "tend")
    for nm, a, b in list(zip(names, out, res))[3:]:
        if a.dtype != b.dtype or not np.array_equal(a[rows], b):
            raise AssertionError(f"2-shard step: {nm} differs from the "
                                 "one-shard step's")
    if not same_contigs(contigs2, contigs):
        raise AssertionError("2-shard Assembly batch != phase 7's")
    sw_err = max(check_sw(sw_cuda, *c[:4], *c[4:], dev) for c in sws)
    held_sorts = []
    for (shape, nk, npay), (n, ops) in sorted(sorts.items()):
        check_sort(psort, ops, nk)
        held_sorts.append([list(shape), nk, npay, n])
    held_sw = sorted({(tuple(c[0].shape), c[2].shape[1]) for c in sws})
    del sorts, sws

    one = lambda: sl.run_step(pdims, pin, device=dev)
    two = lambda: step(*placed)
    two()
    windows = {"one_shard": [], "two_shards": []}
    for name in ("one_shard", "two_shards", "two_shards", "one_shard"):
        windows[name].append(step_window(
            one if name == "one_shard" else two, STEPS_PER_WINDOW))
    prof = profile_one_step(two, top=5)
    return {"check": {
        "n_shards": N, "gaps_per_shard": dims.gaps_per_shard,
        "step_equal_one_shard": True, "counts": counts.tolist(),
        "one_shard_counts": res[0].tolist(),
        "assembly_batch_equal_phase7": True,
        "sw_shapes_equal_plain": [[list(q), t] for q, t in held_sw],
        "sw_max_abs_err": sw_err, "sort_shapes_equal_plain": held_sorts},
        "launches": launches, "summary": summarize(dims, out),
        "time": {k: [w["ms_per_step"] for w in v]
                 for k, v in windows.items()},
        "issue_ms": {k: [w["issue_ms_per_step"] for w in v]
                     for k, v in windows.items()},
        "profile": {k: prof[k] for k in ("device_busy_ms", "device_kernels",
                                         "profiled_wall_ms",
                                         "hand_kernels")}}


def free_port() -> int:
    import socket
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def run_ranks(cmds, timeout: float, threads: int, logdir) -> list:
    """Start every rank with `threads` intra-op threads, its output to
    a file under `logdir`, and wait for all under one timeout; kill them
    all as soon as one fails or the timeout passes, and raise. Returns
    each rank's output."""
    env = dict(os.environ, OMP_NUM_THREADS=str(threads))
    env["PYTHONPATH"] = os.path.dirname(os.path.abspath(__file__))
    os.makedirs(logdir, exist_ok=True)
    logs = [open(os.path.join(logdir, f"rank{i}.log"), "w+")
            for i in range(len(cmds))]
    procs = [subprocess.Popen(c, env=env, stdout=fh,
                              stderr=subprocess.STDOUT)
             for c, fh in zip(cmds, logs)]
    deadline = time.monotonic() + timeout
    killed = []
    try:
        while any(p.poll() is None for p in procs) and \
                all(p.returncode in (None, 0) for p in procs) and \
                time.monotonic() < deadline:
            time.sleep(0.2)
    finally:
        for i, p in enumerate(procs):
            if p.poll() is None:
                p.kill()
                p.wait()
                killed.append(i)
    outs = []
    for fh in logs:
        fh.seek(0)
        outs.append(fh.read())
        fh.close()
    bad = [i for i, p in enumerate(procs) if p.returncode != 0]
    if bad:
        first = ([i for i in bad if i not in killed] or bad)[0]
        raise AssertionError(
            f"rank exit codes {[p.returncode for p in procs]}, killed "
            f"{killed} (past {timeout} s or beside a failed rank); rank "
            f"{first}:\n{outs[first][-4000:]}")
    return outs


# a rank of phase 15: held_rank(module, argv)
RANK = ("import sys, chip_smoke; "
        "sys.exit(chip_smoke.held_rank(sys.argv[1], sys.argv[2:]))")


def held_rank(module: str, argv) -> int:
    """One rank of phase 15: `module`'s main(argv) (the CLI or the
    step's worker) with the counts set to 0 just before and read just
    after, every SW call (in `swutil` and in the step) and sort call
    recorded with one input set a call shape; then each shape held to
    its plain version on those inputs on this rank's card. Prints one
    `held {...}` line: the counts, the held shapes, the largest error.
    A mismatch raises, so the rank exits non-zero."""
    import importlib
    from gappadder_tpu_torch.ops import psort, sw_cuda, swutil
    from gappadder_tpu_torch.parallel import slice as sl
    main = importlib.import_module(module).main
    sw_calls: dict = {}

    def recording(inner):
        def record(q, qlen, t, tlen, params, mode="local", end_slack=0):
            key = (mode, tuple(q.shape), tuple(t.shape), params, end_slack)
            sw_calls[key] = (sw_calls.get(key, (0,))[0] + 1, (
                q.clone(), qlen.clone(), t.clone(), tlen.clone()))
            return inner(q, qlen, t, tlen, params, mode, end_slack)
        return record

    with contextlib.ExitStack() as stack:
        for m in (swutil, sl):
            stack.enter_context(patched(m, "sw_batch_cuda",
                                        recording(m.sw_batch_cuda)))
        sorts = stack.enter_context(recording_sorts(psort))
        sw_cuda.launches = psort.launches = 0
        rc = main(argv)
        torch.cuda.synchronize()
        launches = {"sw": sw_cuda.launches, "sort": psort.launches}
    err, held_sw = 0, []
    for (mode, qs, ts, params, slack), (n, args) in sw_calls.items():
        err = max(err, check_sw(sw_cuda, *args, params, mode, slack, None))
        held_sw.append([mode, list(qs), ts[1], slack, n])
    held_sort = []
    for (shape, nk, npay), (n, ops) in sorted(sorts.items()):
        check_sort(psort, ops, nk)
        held_sort.append([list(shape), nk, npay, n])
    print("held " + json.dumps({
        "launches": launches, "sw_shapes_equal_plain": held_sw,
        "sort_shapes_equal_plain": held_sort, "max_abs_err": err}),
        flush=True)
    return rc


def rank_holds(outs) -> list:
    """Each rank's `held` record (held_rank's line)."""
    return [json.loads([ln for ln in o.splitlines()
                        if ln.startswith("held ")][0][5:]) for o in outs]


def multiprocess_phase(root, chain, clirun, shards) -> dict:
    """Phase 15, two processes on the one card (both drive cuda:0, so
    the collectives go over gloo): (a) `parallel/mp_slice_worker.py` at
    the production shape, one shard a process; its per-gap JSON equals
    phase 14's 2-shard step's; (b) the CLI's `-c All --parity-files
    --force` in two processes (`--coordinator`) on phase 12's files and
    phase 13's config path, whose `tpu.mesh_shape` is [2], so Collect's
    pass 1 and the Assembly batches split over the processes: phase
    13's workspace moves aside and every file of the 2-process run
    equals phase 12's direct calls' (which phase 13's `-c All` wrote too)
    and phase 13's own, byte for byte. Every rank of both runs is a
    `held_rank`: every SW and sort call shape it made equals the plain
    version on that rank's own inputs. The kernels are built (phase 1);
    the ranks load them. Each rank runs under one timeout and both are
    killed when one fails."""
    import shutil
    from gappadder_tpu_torch.testcases import same_workspace

    # (a) the step across two processes
    out_json = os.path.join(root, "mp_slice.json")
    scenario = json.dumps(dict(PRODUCTION, gaps_per_shard=PRODUCTION[
        "gaps_per_shard"] // 2))
    port = free_port()
    t = time.perf_counter()
    outs = run_ranks([[sys.executable, "-c", RANK,
                       "gappadder_tpu_torch.parallel.mp_slice_worker",
                       str(pid), "2", "1", str(port), out_json, "--device",
                       "cuda", "--scenario", scenario] for pid in range(2)],
                     600, 4, os.path.join(root, "ranks_worker"))
    worker_s = time.perf_counter() - t
    worker_held = rank_holds(outs)
    with open(out_json) as fh:
        got = json.load(fh)
    for key in ("counts", "hist", "total_recv", "per_gap"):
        if got[key] != shards["summary"][key]:
            raise AssertionError(f"2-process step: {key} differs from "
                                 "phase 14's")

    # (b) the CLI across two processes, on phase 13's config path
    cfg = chain["cfg"]
    work = cfg.workdir.rstrip("/")
    one = os.path.join(root, "cli_one_process")
    shutil.move(work, one)
    cfg_path = os.path.join(root, "config.json")
    port = free_port()
    t = time.perf_counter()
    outs = run_ranks([[sys.executable, "-c", RANK, "gappadder_tpu_torch.cli",
                       "-c", "All", "-g", cfg_path, "--parity-files",
                       "--force", "--coordinator", f"127.0.0.1:{port}",
                       "--num-processes", "2", "--process-id", str(pid)]
                      for pid in range(2)], 900, 4,
                     os.path.join(root, "ranks_cli"))
    cli_s = time.perf_counter() - t
    cli_held = rank_holds(outs)
    dist_lines = [ln for o in outs for ln in o.splitlines()
                  if ln.startswith("[dist]")]
    backend = dist_lines[0].split(" backend ")[1].split()[0]
    if backend != "gloo" or len(dist_lines) != 2:
        raise AssertionError(f"2-process CLI: {dist_lines}")
    files = same_workspace(os.path.join(root, "chain_direct"), work)
    same_workspace(work, one, files)
    for name, held in (("worker", worker_held), ("cli", cli_held)):
        for r, h in enumerate(held):
            if min(h["launches"].values()) < 1:
                raise AssertionError(f"2-process {name} rank {r} launched "
                                     f"{h['launches']}")
    with open(os.path.join(work, "metrics.json")) as fh:
        stages = json.load(fh)["stages"]
    return {"check": {
        "worker_equal_phase14": True, "worker_backend": got["backend"],
        "worker_n_shards": got["n_shards"],
        "cli_equal_one_process": True, "cli_files": len(files),
        "cli_backend": backend, "dist_lines": dist_lines,
        "host_staged": False,
        # every rank's SW and sort call shapes, each equal to plain
        "worker_ranks_held": worker_held, "cli_ranks_held": cli_held},
        "launches": got["launches"], "cli_launches": cli_held[0]["launches"],
        "time": {"worker_wall_s": worker_s, "worker_step_s": got["step_s"],
                 "cli_wall_s": cli_s,
                 "cli_stage_s": {k: v["seconds"] for k, v in stages.items()},
                 "one_process_all_s": clirun["all_s"],
                 "one_process_stage_s": clirun["stage_s"]}}


def hold_driver_calls(clock, dev):
    """Every SW call shape a DriverClock recorded, held to the plain
    version on that call's own inputs, and every sort call shape on its
    own planes. Returns (sw_keys {(mode, q shape, t shape, params,
    slack): (calls, stages, inputs)}, held SW rows, held sort rows)."""
    from gappadder_tpu_torch.ops import psort, sw_cuda
    sw_keys: dict = {}
    for lab, args, params, mode, slack in clock.sw_calls:
        key = (mode, tuple(args[0].shape), tuple(args[2].shape), params,
               slack)
        n, labs, _ = sw_keys.get(key, (0, set(), None))
        sw_keys[key] = (n + 1, labs | {lab}, args)
    clock.sw_calls = []
    held_sw = []
    for (mode, qs, ts, params, slack), (n, labs, args) in sw_keys.items():
        check_sw(sw_cuda, *args, params, mode, slack, dev)
        held_sw.append([mode, qs[0], qs[1], ts[1], slack, n, sorted(labs)])
    held_sort = []
    for (shape, nk, npay), (n, labs, ops) in sorted(clock.sorts.items()):
        check_sort(psort, ops, nk)
        held_sort.append([list(shape), nk, npay, n, sorted(labs)])
    return sw_keys, held_sw, held_sort


def sw_shape_time(sw_cuda, args, params, mode, slack, ops_s,
                  live_cells=None) -> dict:
    """The SW kernel on one batch: ms by CUDA events, device ms by the
    profiler, its cells (those of `live_cells` pairs if given, else all)
    and the operations bound on them, and the share of the kernel's
    lane-row cell slots that are those cells."""
    q, ql, t, tl = args
    B, Lq = q.shape
    Lt = t.shape[1]
    qrows = torch.clamp(ql, max=Lq).long()
    cells = int((qrows * torch.clamp(tl, min=0, max=Lt).long()).sum())
    live_cells = cells if live_cells is None else live_cells
    fn = lambda: sw_cuda.sw_batch_cuda(q, ql, t, tl, params, mode, slack)
    fn()
    ms = cuda_ms(fn, 5)
    slots = sw_cuda.cell_slots(ql, tl, Lq, Lt)
    # a local cell clamps at 0; the other modes do one max less
    ops = live_cells * (SW_OPS_PER_CELL if mode == "local"
                        else SW_OPS_PER_CELL - 1)
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    return {"shape": [B, Lq, Lt], "mode": mode, "ms": ms,
            "device_ms": kernel_device_ms(fn, 5, "sw_kernel"),
            "cells": cells, "live_cells": live_cells,
            "gcups_live": live_cells / (ms / 1e3) / 1e9,
            "rows_per_lane": sw_cuda.rows_per_lane(Lq), "cell_slots": slots,
            "live_share": live_cells / slots if slots else None,
            "ps_per_cell_slot_per_sm": ms * 1e9 * sms / slots if slots
            else None,
            **bound(ops, B * (Lq + Lt) + 8 * B + 12 * B, ops_s)}


def library_sort(ops, nk):
    """One stable torch.sort plus gathers that computes the same sort,
    where there is one: one key as it is; two keys packed into one int64,
    the first key high, where each key plane's values all lie in
    [0, 2^32) (bias 0) or in [-2^31, 2^31) (bias 2^31), read on the
    host; else None. The high word is taken less 2^31, so the packed key
    orders as a signed int64."""
    if nk == 1:
        key = lambda: ops[0]
    elif nk == 2:
        bias = []
        for o in ops[:2]:
            lo, hi = (int(o.min()), int(o.max())) if o.numel() else (0, 0)
            if 0 <= lo and hi < 1 << 32:
                bias.append(0)
            elif -(1 << 31) <= lo and hi < 1 << 31:
                bias.append(1 << 31)
            else:
                return None
        b0, b1 = bias[0] - (1 << 31), bias[1]
        key = lambda: (ops[0] + b0) * (1 << 32) + (ops[1] + b1)
    else:
        return None

    def library():
        idx = torch.sort(key(), dim=-1, stable=True).indices
        return [torch.gather(o, -1, idx) for o in ops]
    return library


def sort_times(psort, step) -> dict:
    """The sort kernel at each distinct call shape of one production
    step, on the step's own inputs (`sort_shape_times`), summed over the
    step's calls (the library's only where every shape has one)."""
    with recording_sorts(psort) as calls:
        step()
    shapes = sort_shape_times(psort, calls)
    tot = {"step_ms": 0.0, "step_device_ms": 0.0, "step_plain_ms": 0.0,
           "step_bound_ms": 0.0, "step_library_ms": 0.0,
           "step_cuda_launches": 0.0}
    for r in shapes:
        count = r["calls"]
        for key, col in (("step_ms", "ms"), ("step_device_ms", "device_ms"),
                         ("step_cuda_launches", "cuda_launches_per_call"),
                         ("step_plain_ms", "plain_ms"),
                         ("step_bound_ms", "bound_ms")):
            tot[key] += count * r[col]
        if r["library_ms"] is not None:
            tot["step_library_ms"] += count * r["library_ms"]
    if any(r["library_ms"] is None for r in shapes):
        tot["step_library_ms"] = None
    for r in shapes:
        r["calls_per_step"] = r.pop("calls")
    return dict(tot, calls_per_step=sum(c for c, _ in calls.values()),
                shapes=shapes)


def sort_shape_times(psort, calls) -> list:
    """The sort kernel at each recorded call shape ({(shape, keys,
    payloads): [calls, planes]}), on that call's own planes: ms by CUDA
    events, device ms and CUDA launches per call by the profiler, the
    plain sort, the library sort where there is one (`library_sort`,
    held equal to the kernel's result first), and the bytes bound (each
    plane read and written once, 8 bytes an element, at the HBM rate)."""
    shapes = []
    for (shape, nk, npay), (count, ops) in sorted(calls.items()):
        elems = int(np.prod(shape))
        bound_ms = 2 * 8 * elems * (nk + npay) / HBM_BYTES_PER_S * 1e3
        kern_fn = lambda: psort.bitonic_sort(ops, nk)
        kern = cuda_ms(kern_fn, 10)
        dev_ms, cuda_launches, _ = kernel_profile(kern_fn, 5, "psort_")
        plain = cuda_ms(lambda: psort.bitonic_sort_plain(ops, nk), 10)
        library = library_sort(ops, nk)
        lib = None
        if library is not None:
            for g, w in zip(library(), kern_fn()):
                if not torch.equal(g, w):
                    raise AssertionError(f"library sort != kernel at {shape}")
            lib = cuda_ms(library, 10)
        shapes.append({"shape": list(shape), "keys": nk, "payloads": npay,
                       "calls": count, "ms": kern, "device_ms": dev_ms / 5,
                       "cuda_launches_per_call": cuda_launches / 5,
                       "plain_ms": plain, "library_ms": lib,
                       "bound_ms": bound_ms})
    return shapes


def check_probes(ke, sp, ir, dev, fill_tiles: int) -> dict:
    """Every probe kernel against its plain twin on the card, exactly:
    at the scripts' shapes on seeded inputs (the int16 loop where int16
    wraps, the argmax loop with ties, every swprobe level, also near
    INT32_MAX), then rows 4-6 at `fill_tiles` tiles of 128 columns, rows
    4 and 5 (and the yardsticks) at `LOOP_SHAPES`, row 6 at its band
    edges (`testcases.SWPROBE_SHAPES`). Returns, by launch
    counter, the cases run and the max abs difference (0); raises on the
    first difference."""
    from gappadder_tpu_torch.testcases import (ARGMAX_INPUTS,
                                               INT16_LOOP_INPUTS,
                                               SWPROBE_INPUTS, SWPROBE_SHAPES,
                                               probe_input)
    keys = (*PROBE_KERNELS, "loop_yardstick")
    cases = dict.fromkeys(keys, 0)
    errs = dict.fromkeys(keys, 0)

    def same(key, got, want):
        got = got if isinstance(got, tuple) else (got,)
        want = want if isinstance(want, tuple) else (want,)
        for g, w in zip(got, want):
            if g.shape != w.shape or g.dtype != w.dtype:
                raise AssertionError(f"probe {key}: kernel gives "
                                     f"{g.dtype}{tuple(g.shape)}, plain "
                                     f"{w.dtype}{tuple(w.shape)}")
            err = int((g.long() - w.long()).abs().max())
            if err:
                raise AssertionError(f"probe {key}: kernel != plain at "
                                     f"{tuple(w.shape)}, max abs err {err}")
            errs[key] = max(errs[key], err)
        cases[key] += 1

    def on(a):
        return torch.from_numpy(a).to(dev)

    t = on(probe_input("beyond_int16", (64, 128), 3))
    for j in (17, 0, 63, 64, 70, -1, -5, -70):
        idx = torch.tensor([[j]], dtype=torch.int32, device=dev)
        same("dynamic_sublane", ke.exp_dynamic_sublane(t, idx),
             ke.exp_dynamic_sublane_plain(t, idx))
    W = 128 * fill_tiles
    for shape in ((ke.S, ke.TB), (ke.S, W), *LOOP_SHAPES):
        for name in INT16_LOOP_INPUTS:
            x = on(probe_input(name, shape, 1))
            same("int16_loop", ke.exp_int16_loop(x), ke.exp_int16_loop_plain(x))
        # within +-16000 nothing wraps, so the yardsticks equal the loop
        x = on(probe_input("beyond_int16", shape, 9) // 100)
        want = ke.exp_int16_loop_plain(x)
        for lanes, dpx in YARDSTICKS:
            same("loop_yardstick", ke.recurrence_yardstick(x, lanes=lanes,
                                                           dpx=dpx), want)
        for name in ARGMAX_INPUTS:
            x = on(probe_input(name, shape, 2))
            same("int32_argmax", ke.exp_int32_loop_with_argmax(x),
                 ke.exp_int32_loop_with_argmax_plain(x))
    for x in (sp.script_input(1), sp.script_input(2, tiles=fill_tiles),
              probe_input("near_int32_max", (sp.S, sp.NBT * sp.TB), 5),
              *(probe_input(name, shape, sum(shape))
                for shape in SWPROBE_SHAPES for name in SWPROBE_INPUTS)):
        x = on(x)
        for level in sp.LEVELS:
            same("swprobe", sp.run(x, level), sp.run_plain(x, level))
    for x in (ir.script_input(), probe_input("int16_full", ir.SHAPE, 4),
              probe_input("int16_full", (7, 33), 5),
              probe_input("int16_full", (1, 7), 6),
              probe_input("int16_full", (1025, 33), 7)):
        x = on(x)
        same("int16_elementwise", ir.elementwise(x), ir.elementwise_plain(x))
        same("int16_roll", ir.roll(x), ir.roll_plain(x))
    # rows off the 16-byte vector; the copies where bytes set the time and
    # at the odd shape (3000 rows, a start 2 bytes into its storage)
    t = on(probe_input("beyond_int16", (9, 37), 3))
    for j in (0, 1, 2, 3, 9, -1):
        idx = torch.tensor([[j]], dtype=torch.int32, device=dev)
        same("dynamic_sublane", ke.exp_dynamic_sublane(t, idx),
             ke.exp_dynamic_sublane_plain(t, idx))
    for key, label, case in copy_cases(ke, ir, dev):
        if label != "script":
            same(key, case["kernel"](), case["plain"]())
    return {"cases": cases, "max_abs_err": errs}


def int_ops_per_s(props, sm_clock_mhz: float) -> float:
    """The peak rate of the int32 (and int16x2) operations the bounds
    count: each SM's 4 schedulers issue at most one warp instruction a
    clock, 128 lanes, and every counted operation takes one lane's
    instruction at least. (The SM's 64 INT32 lanes alone undercount it:
    the warp-band loops run their VIADD, VIADDMNMX and VIMNMX at 2.7-3
    warp instructions a clock an SM.)"""
    return props.multi_processor_count * 128 * sm_clock_mhz * 1e6


def bound(ops: float, nbytes: float, ops_s: float) -> dict:
    """The least time for `ops` int32 operations and `nbytes` of device
    memory traffic, and which of the two sets it."""
    ops_ms = ops / ops_s * 1e3
    bytes_ms = nbytes / HBM_BYTES_PER_S * 1e3
    return {"bound_ms": max(ops_ms, bytes_ms), "bound_ops_ms": ops_ms,
            "bound_bytes_ms": bytes_ms,
            "bound_by": "operations" if ops_ms >= bytes_ms else "bytes"}


def probe_times(ke, sp, ir, probes, dev, sms: int, ops_s: float) -> dict:
    """Each probe kernel at its script's shape: ms by CUDA events over
    back-to-back launches (at the small shapes that is the host's issue
    time of a wrapper call), the kernel's own device ms (profiler), its
    plain twin's ms, the one PyTorch call that computes the same where
    there is one, and its bound. Rows 4-6 (and
    the int16 loop's yardsticks) also at 4 tiles of 128 columns an SM,
    per step and, for swprobe, per tile-step and level. At the script's
    small shapes the dependent chain of steps (or, for the copies, the
    launch) sets the time, not the throughput bound. Rows 3 and 7 (the
    copies) in interleaved windows with their library call and plain
    twin, also where bytes set the time and at an odd shape
    (`copy_cases`), with the launch floor; and the host's parts of one
    wrapper call (`host_parts`)."""
    fill = FILL_TILES_PER_SM * sms
    res = loop_times(ke, dev, fill, ops_s)

    levels = {}
    for tiles in (sp.NBT, fill):
        x = torch.from_numpy(sp.script_input(0, tiles=tiles)).to(dev)
        S, W = x.shape
        for level in sp.LEVELS:
            r = time_case(lambda: sp.run(x, level),
                          lambda: sp.run_plain(x, level),
                          S * W * (sp.NSTEP * SW_LEVEL_OPS[level] + 5),
                          4 * S * W + 4 * W, "swprobe_kernel", ops_s,
                          reps=50 if tiles == sp.NBT else 10)
            # per step, from the kernel's device time
            per = r["device_ms"] * 1e6 / sp.NSTEP
            levels[f"level{level}_{'script' if tiles == sp.NBT else 'fill'}"] \
                = dict(r, shape=[S, W], ns_per_step=r["ms"] * 1e6 / sp.NSTEP,
                       device_ns_per_step=per,
                       device_ns_per_tile_step=per / tiles,
                       device_ns_per_tile_step_per_sm=per / tiles * sms,
                       device_ps_per_thread_step_per_sm=per * 1e3 * sms /
                       (S * W))
    res["swprobe"] = dict(levels["level3_script"], levels=levels)

    # rows 3 and 7: the copies at the script shapes, at fill and odd
    for key, label, case in copy_cases(ke, ir, dev):
        r = time_copy_case(case, ops_s)
        if label == "script":
            res[key] = r
        else:
            res[key][label] = r
    res["host_parts"] = host_parts(ke, ir, probes, dev)
    return res


def time_case(kern, plain, ops, nbytes, tag, ops_s: float, library=None,
              plain_reps=1, reps=50) -> dict:
    """One probe kernel's times: ms by CUDA events over `reps`
    back-to-back calls, its device ms (the profiler's kernel whose name
    holds `tag`), its plain twin's ms, the library call's where there is
    one, and the bound of `ops` int32 operations and `nbytes` bytes."""
    kern()
    return {"ms": cuda_ms(kern, reps),
            "device_ms": kernel_device_ms(kern, reps, tag),
            "plain_ms": cuda_ms(plain, plain_reps),
            "library_ms": cuda_ms(library, reps) if library else None,
            **bound(ops, nbytes, ops_s)}


def loop_times(ke, dev, fill: int, ops_s: float) -> dict:
    """Rows 4 and 5 and the int16 loop's yardsticks on zeros at the
    script's shape [128, 128] and at `fill` tiles of 128 columns
    (`check_probes` holds them to their plain twins there), timed
    (`time_case`), with ns a step; and the yardsticks' int32 over
    int16x2 ratio at fill."""
    steps = ke.STEPS

    def loop_case(kern, plain, W, ops_el, tag, extra_bytes=0):
        x = torch.zeros((ke.S, W), dtype=torch.int32, device=dev)
        r = time_case(lambda: kern(x), lambda: plain(x),
                      ke.S * W * steps * ops_el, 8 * ke.S * W + extra_bytes,
                      tag, ops_s, reps=50 if W == ke.TB else 10)
        return dict(r, shape=[ke.S, W], ns_per_step=r["ms"] * 1e6 / steps,
                    device_ns_per_step=r["device_ms"] * 1e6 / steps)

    res = {}
    for key, kern, plain, ops_el, tag, extra in (
            ("int16_loop", ke.exp_int16_loop, ke.exp_int16_loop_plain,
             OPS_LOOP_WORD / 2, "loop_kernel", 0),
            ("int32_argmax", ke.exp_int32_loop_with_argmax,
             ke.exp_int32_loop_with_argmax_plain, OPS_ARGMAX,
             "int32_argmax_kernel", 4)):
        res[key] = loop_case(kern, plain, ke.TB, ops_el, tag, extra * ke.TB)
        res[key]["fill"] = loop_case(kern, plain, ke.TB * fill, ops_el, tag,
                                     extra * ke.TB * fill)
    yard = {}
    for lanes, dpx in ((2, False),) + YARDSTICKS:
        f = lambda x, lanes=lanes, dpx=dpx: ke.recurrence_yardstick(
            x, lanes=lanes, dpx=dpx)
        for shape, W in (("script", ke.TB), ("fill", ke.TB * fill)):
            r = loop_case(f, ke.exp_int16_loop_plain, W,
                          OPS_LOOP_WORD / lanes, "loop_kernel")
            yard[f"lanes{lanes}_dpx{int(dpx)}_{shape}"] = {
                k: r[k] for k in ("ms", "device_ms", "ns_per_step",
                                  "device_ns_per_step", "bound_ms")}
    res["loop_yardsticks"] = yard
    res["int16x2_gain_fill"] = (yard["lanes1_dpx0_fill"]["ms"] /
                                yard["lanes2_dpx0_fill"]["ms"])
    res["int16x2_device_gain_fill"] = (
        yard["lanes1_dpx0_fill"]["device_ms"] /
        yard["lanes2_dpx0_fill"]["device_ms"])
    return res


def kernel_label(mangled: str):
    """"loop_kernel<2,0,4,1>" (template arguments in order) for a loop
    kernel's mangled name (`swprobe_kernel<LEVEL,R>` too); None for
    other kernels."""
    m = re.search(r"(loop_kernel|int32_argmax_kernel|swprobe_kernel)I"
                  r"((?:L[ib]\d+E)+)E", mangled)
    if not m:
        return None
    args = re.findall(r"L[ib](\d+)E", m.group(2))
    return f"{m.group(1)}<{','.join(args)}>"


def script_band(label: str) -> bool:
    """The loop kernels the scripts' shapes run: rows 4 and 5 at 128
    rows, R = 4 with every row live; swprobe at 136 rows, R = 5."""
    args = label.partition("<")[2].rstrip(">").split(",")
    if label.startswith("swprobe_kernel"):
        return args[-1] == "5"
    return args[-2:] == ["4", "1"]


def loop_sass(lib: str, nvcc: str) -> dict:
    """The step loop of each loop kernel the script's shape runs
    (`script_band`), read from the SASS of the probes library `lib`
    (cuobjdump -sass, beside `nvcc`): the body of the loop that holds
    the most steps (a backward branch, its target up to it), the steps
    it holds (rows 4 and 5: one SHFL.IDX a step; swprobe: R LDS a step,
    its reads of tr, which every level has), instructions a step, a word
    and step (a lane's step covers its band of R rows) and an element
    and step (the int16 loop's word holds two columns), the REDUX, SHFL,
    LDS and BAR instructions a step and the body's opcodes. NOPs are not
    counted."""
    tool = os.path.join(os.path.dirname(nvcc), "cuobjdump")
    text = subprocess.run([tool, "-sass", lib], capture_output=True,
                          text=True, check=True).stdout
    out = {}
    for func in re.split(r"\n\s*Function : ", text)[1:]:
        label = kernel_label(func.split("\n", 1)[0])
        if label is None or not script_band(label):
            continue
        args = [int(a) for a in label.partition("<")[2].rstrip(">").split(",")]
        sw = label.startswith("swprobe_kernel")
        rows = args[-1] if sw else args[-2]
        cols = args[0] if label.startswith("loop_kernel") else 1
        labels, code = {}, []
        pending = []
        for line in func.splitlines():
            lm = re.match(r"\s*(\.L_x_\d+):", line)
            if lm:
                pending.append(lm.group(1))
                continue
            im = re.search(r"/\*([0-9a-f]{4,})\*/\s+(.*?)\s*;", line)
            if im:
                addr = int(im.group(1), 16)
                for name in pending:
                    labels[name] = addr
                pending = []
                code.append((addr, im.group(2)))
        opcode = lambda ins: re.sub(r"^@!?U?P\w+\s+", "", ins).split()[0]
        best = None
        for addr, ins in code:
            bm = re.search(r"BRA\s+(?:`\()?(\.L_x_\d+|0x[0-9a-f]+)", ins)
            if not bm:
                continue
            t = bm.group(1)
            target = labels.get(t) if t.startswith(".L") else int(t, 16)
            if target is None or target > addr:
                continue
            ops = [opcode(i) for a, i in code
                   if target <= a <= addr and opcode(i) != "NOP"]
            marks = (sum(o.startswith("LDS") for o in ops) / rows if sw else
                     sum(o.startswith("SHFL.IDX") for o in ops))
            if marks and (best is None or marks > best[1]):
                best = (ops, marks)
        if best is None:
            out[label] = None
            continue
        ops, steps = best
        count = lambda p: sum(o.startswith(p) for o in ops) / steps
        out[label] = {"body": len(ops), "steps": steps,
                      "per_step": len(ops) / steps,
                      "per_word_step": len(ops) / steps / rows,
                      "per_element_step": len(ops) / steps / rows / cols,
                      "redux_per_step": count("REDUX"),
                      "shfl_per_step": count("SHFL"),
                      "lds_per_step": count("LDS"),
                      "bar_per_step": count("BAR"),
                      "opcodes": dict(sorted(
                          {o: ops.count(o) for o in set(ops)}.items()))}
    return out


def ptxas_loops(report: str) -> dict:
    """From nvcc's -Xptxas -v report of the probes: registers and
    spill-store bytes of every loop kernel, and the most of each."""
    got, label = {}, None
    for line in report.splitlines():
        m = re.search(r"Compiling entry function '([^']+)'", line)
        if m:
            label = kernel_label(m.group(1))
            if label:
                got[label] = {}
            continue
        if not label:
            continue
        m = re.search(r"(\d+) bytes spill stores", line)
        if m:
            got[label]["spill_store_bytes"] = int(m.group(1))
        m = re.search(r"Used (\d+) registers", line)
        if m:
            got[label]["registers"] = int(m.group(1))
    return {"kernels": got,
            "max_spill_store_bytes": max(
                (v.get("spill_store_bytes", 0) for v in got.values()),
                default=None),
            "max_registers": max((v.get("registers", 0)
                                  for v in got.values()), default=None)}


def interleaved(fns: dict, reps: int, windows: int = COPY_WINDOWS) -> dict:
    """ms per call of each of `fns` by CUDA events: `windows` rounds, in
    each one window of `reps` back-to-back calls of every fn in turn
    (kernel, library, plain, kernel, ...). Every window and the median
    by fn."""
    for f in fns.values():
        f()
    got = {k: [] for k in fns}
    for _ in range(windows):
        for k, f in fns.items():
            got[k].append(cuda_ms(f, reps))
    return {k: {"median_ms": float(np.median(v)), "windows_ms": v}
            for k, v in got.items()}


def copy_cases(ke, ir, dev):
    """Rows 3 and 7 (the dynamic row read, int16 roll and elementwise)
    as timing cases, each built when it is reached: (launch counter,
    shape label, case). Labels: "script" (the script's shape, where the
    launch sets the time), "fill" (where bytes set it: t int32 [16,
    2^24] with row 11, int16 [32, 2^22]) and, for the int16 pair,
    "odd" (int16 [3000, 4097] starting 2 bytes into its storage: more
    than 1024 rows, widths off the 16-byte vector, a misaligned
    start). A case: kernel, plain, library (or None), the kernel's
    name tag, the bytes its function must move (each input read once,
    each output written once) and the shape."""
    def sublane(t, j):
        idx = torch.tensor([[j]], dtype=torch.int32, device=dev)
        jl = idx.reshape(1).long()
        return {"kernel": lambda: ke.exp_dynamic_sublane(t, idx),
                "plain": lambda: ke.exp_dynamic_sublane_plain(t, idx),
                "library": lambda: torch.index_select(t, 0, jl),
                "library_call": "torch.index_select",
                "tag": "dynamic_sublane_kernel", "bytes": 4 + 8 * t.shape[1],
                "shape": list(t.shape)}

    def int16(x):
        n = x.numel()
        yield "int16_roll", {
            "kernel": lambda: ir.roll(x), "plain": lambda: ir.roll_plain(x),
            "library": lambda: torch.roll(x, 1, 0),
            "library_call": "torch.roll", "tag": "int16_roll_kernel",
            "bytes": 4 * n, "shape": list(x.shape)}
        yield "int16_elementwise", {
            "kernel": lambda: ir.elementwise(x),
            "plain": lambda: ir.elementwise_plain(x), "library": None,
            "library_call": "none: no one PyTorch call computes wrapping "
                            "max(x + 3, x - 2)",
            "tag": "int16_elementwise_kernel", "bytes": 4 * n,
            "shape": list(x.shape)}

    yield "dynamic_sublane", "script", sublane(
        torch.from_numpy(ke.script_table()).to(dev), ke.SUBLANE_ROW)
    R, W, j = SUBLANE_FILL
    yield "dynamic_sublane", "fill", sublane(
        torch.arange(R * W, dtype=torch.int32, device=dev).view(R, W), j)
    g = torch.Generator(device=dev).manual_seed(7)
    S, W = INT16_ODD
    base = torch.randint(-(1 << 15), 1 << 15, (S * W + 1,), generator=g,
                         device=dev, dtype=torch.int32).to(torch.int16)
    for label, x in (("script", torch.from_numpy(ir.script_input()).to(dev)),
                     ("fill", torch.randint(
                         -(1 << 15), 1 << 15, INT16_FILL, generator=g,
                         device=dev, dtype=torch.int32).to(torch.int16)),
                     ("odd", base[1:].view(S, W))):
        for key, case in int16(x):
            yield key, label, case


def time_copy_case(case, ops_s: float) -> dict:
    """One copy case: the kernel, its library call and its plain twin in
    interleaved windows (`interleaved`: 7 windows of 50 calls at the
    script shape, of 10 where bytes set the time), the kernel's device
    ms and the launch floor by the profiler, and the bytes bound."""
    small = case["bytes"] < 1 << 20
    reps = COPY_REPS if small else FILL_REPS
    fns = {"kernel": case["kernel"], "library": case["library"],
           "plain": case["plain"]}
    w = interleaved({k: f for k, f in fns.items() if f}, reps)
    device_ms, floor_ms = kernel_device_times(case["kernel"], reps,
                                              case["tag"])
    b = bound(0, case["bytes"], ops_s)
    lib = w.get("library", {})
    return {"shape": case["shape"], "bytes": case["bytes"],
            "ms": w["kernel"]["median_ms"],
            "windows_ms": w["kernel"]["windows_ms"],
            "device_ms": device_ms, "launch_floor_ms": floor_ms,
            "plain_ms": w["plain"]["median_ms"],
            "plain_windows_ms": w["plain"]["windows_ms"],
            "library_ms": lib.get("median_ms"),
            "library_windows_ms": lib.get("windows_ms"),
            "library_call": case["library_call"], **b,
            "device_bound_share": b["bound_ms"] / device_ms,
            "calls_per_window": reps}


def host_parts(ke, ir, probes, dev, calls: int = HOST_PART_CALLS,
               rounds: int = HOST_PART_ROUNDS) -> dict:
    """Host nanoseconds of one call of each part of the probe wrappers'
    launch path, and of whole calls, at the scripts' shapes on inputs
    that already lie on the card: each part `calls` times back to back
    (time.perf_counter_ns), in `rounds` rounds of calls / rounds with
    the parts in turn, the median round. "loop" is the empty call that
    every other figure includes. The C entry's call ("ctypes_launch")
    launches the row-read kernel with pointers ready and the stream
    read beforehand; "ctypes_no_launch" is that call on 0 rows, which
    returns before the launch."""
    from gappadder_tpu_torch import entry_device
    t = torch.from_numpy(ke.script_table()).to(dev)
    idx = torch.tensor([[ke.SUBLANE_ROW]], dtype=torch.int32, device=dev)
    jl = idx.reshape(1).long()
    x = torch.from_numpy(ir.script_input()).to(dev)
    out = torch.empty((1, t.shape[1]), dtype=torch.int32, device=dev)
    ke.exp_dynamic_sublane(t, idx)
    fn = probes._fns["dynamic_sublane"]
    index = t.get_device()
    raw = torch._C._cuda_getCurrentRawStream
    cargs = [idx.data_ptr(), t.data_ptr(), t.shape[0], t.shape[1],
             out.data_ptr(), index, raw(index)]
    noop = cargs[:2] + [0] + cargs[3:]

    def context():
        with torch.cuda.device(dev):
            pass

    parts = {
        "loop": lambda: None,
        "entry_device": lambda: entry_device("cuda", "probe"),
        "tensor_on": lambda: probes.tensor_on(t, torch.int32, dev, "probe"),
        "torch_empty": lambda: torch.empty((1, t.shape[1]),
                                           dtype=torch.int32, device=dev),
        "new_empty": lambda: t.new_empty((1, t.shape[1])),
        "empty_like": lambda: torch.empty_like(x),
        "device_context": context,
        "current_stream": lambda: torch.cuda.current_stream(dev).cuda_stream,
        "raw_stream": lambda: raw(index),
        "inputs": lambda: probes.inputs("probe", "cuda", torch.int32, t, idx),
        "data_ptr": t.data_ptr,
        "ctypes_launch": lambda: fn(*cargs),
        # the same call on 0 rows: the entry returns before it launches
        "ctypes_no_launch": lambda: fn(*noop),
        "index_select": lambda: torch.index_select(t, 0, jl),
        "roll": lambda: torch.roll(x, 1, 0),
        "exp_dynamic_sublane": lambda: ke.exp_dynamic_sublane(t, idx),
        "int16_repro.roll": lambda: ir.roll(x),
        "int16_repro.elementwise": lambda: ir.elementwise(x),
    }
    per = calls // rounds
    got = {k: [] for k in parts}
    for f in parts.values():
        for _ in range(100):
            f()
    torch.cuda.synchronize()
    for _ in range(rounds):
        for k, f in parts.items():
            t0 = time.perf_counter_ns()
            for _ in range(per):
                f()
            got[k].append((time.perf_counter_ns() - t0) / per)
            torch.cuda.synchronize()
    return {"calls": calls, "rounds": rounds,
            "ns": {k: float(np.median(v)) for k, v in got.items()},
            "rounds_ns": got}


def kernel_device_ms(fn, reps: int, tag: str, tries: int = 3) -> float:
    """Mean device milliseconds of the one CUDA kernel launch of fn whose
    name holds `tag`, over `reps` calls (`kernel_device_times`)."""
    return kernel_device_times(fn, reps, tag, tries)[0]


def kernel_device_times(fn, reps: int, tag: str, tries: int = 3) -> tuple:
    """(mean device ms of fn's kernel whose name holds `tag`, mean device
    ms of the profiling run's `warm.add_(1)` launches: the launch floor,
    what a kernel that does nearly nothing takes on the device) over
    `reps` calls (`kernel_profile`). A profiling run that records too
    few of the launches (the tracer now and then drops a whole run's
    events, late in a long process every run's) is taken again, up to
    `tries` runs; if none records them, the device time is taken by CUDA
    events instead (`events_device_ms`, every kernel of a call, no
    launch floor) and a `profiler_miss` line says so."""
    seen = []
    for _ in range(tries):
        total_ms, n, floor_ms = kernel_profile(fn, reps, tag)
        if reps // 2 <= n <= reps:
            return total_ms / n, floor_ms
        seen.append(n)
    ms = events_device_ms(fn, reps)
    emit(phase="profiler_miss", tag=tag, reps=reps, seen=seen,
         events_device_ms=ms)
    return ms, None


def events_device_ms(fn, reps: int) -> float:
    """Mean device ms of a call of fn, by CUDA events around `reps`
    back-to-back calls that the host issues while a sleep kernel holds
    the stream, so that the events time the device's work and not the
    host's issue."""
    fn()
    torch.cuda.synchronize()
    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    torch.cuda._sleep(SLEEP_CYCLES)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def kernel_profile(fn, reps: int, tag: str) -> tuple:
    """Device milliseconds and count of the CUDA kernels whose name holds
    `tag` over `reps` calls of fn, by torch.profiler, and the mean device
    ms of the `warm.add_(1)` launches around them. Eight small adds go
    first and eight last: a profiling run can miss launches at its
    edges (its first one; late in a long process on an H100, 4 of each
    run)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    fn()
    warm = torch.zeros(1, device="cuda")
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(8):
            warm.add_(1)
        for _ in range(reps):
            fn()
        for _ in range(8):
            warm.add_(1)
        torch.cuda.synchronize()
    cuda = [e for e in prof.events() if e.device_type == DeviceType.CUDA]
    mine = [e for e in cuda if tag in e.name]
    adds = [e.self_device_time_total for e in cuda
            if "add" in e.name and tag not in e.name]
    return (sum(e.self_device_time_total for e in mine) / 1e3, len(mine),
            sum(adds) / len(adds) / 1e3 if adds else None)


def block_times(sl, dims, a):
    """Milliseconds of the step's blocks at `dims`, by CUDA events."""
    ev = [torch.cuda.Event(enable_timing=True) for _ in range(4)]
    with torch.no_grad():
        torch.cuda.synchronize()
        ev[0].record()
        entries, _ = sl._classify_extract(*a[:18], dims=dims)
        rowtab, _, _, _ = sl._route_and_group(entries, *a[18:22], dims=dims)
        ev[1].record()
        seq, rlen = sl.gather_reads(rowtab, a[22], a[23])
        useq, ulen, _, _, _ = sl._assemble_block(seq, rlen, dims)
        ev[2].record()
        myg = torch.arange(dims.gaps_per_shard, device=useq.device)
        sl._pick_score_block(useq, ulen, a[24][myg], a[25][myg],
                             a[26][myg], a[27][myg])
        ev[3].record()
        torch.cuda.synchronize()
    return {"blocks12_ms": ev[0].elapsed_time(ev[1]),
            "block3_ms": ev[1].elapsed_time(ev[2]),
            "block4_ms": ev[2].elapsed_time(ev[3])}


def profile_step(fn, hand: dict, tries: int = 3, top: int = 10):
    """One production step (fn) under torch.profiler (`profile_one_step`),
    taken again, up to `tries` runs, until the profiler saw each hand
    kernel's CUDA launches as often as the step made them (`hand`, from
    the launch counters): the tracer now and then drops events, and only
    a run that saw all of these counts the step's kernels whole.
    `complete` says whether one did; else the run that saw the most
    kernels is kept."""
    runs = []
    for _ in range(tries):
        r = profile_one_step(fn, top)
        r["complete"] = hand == {k: v["cuda_launches"]
                                 for k, v in r["hand_kernels"].items()}
        runs.append(r)
        if r["complete"]:
            break
    kept = runs[-1] if runs[-1]["complete"] else max(
        runs, key=lambda p: p["device_kernels"])
    return dict(kept, hand_expected=hand, runs=len(runs),
                kernels_seen_by_run=[p["device_kernels"] for p in runs])


def profile_one_step(fn, top: int):
    """One step (fn) under torch.profiler: the summed duration of its
    device kernels (one stream, so they do not overlap), their count,
    the profiled wall time, the hand kernels' device ms and CUDA
    launches, and the torch operators with the most device time."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    kernels = [e for e in prof.events() if e.device_type == DeviceType.CUDA]
    busy_ms = sum(e.self_device_time_total for e in kernels) / 1e3
    ops = sorted((e for e in prof.key_averages()
                  if e.key.startswith("aten::")),
                 key=lambda e: e.self_device_time_total, reverse=True)[:top]
    # the hand-written kernels run under no aten operator: read them
    # by their CUDA function names (csrc/sort.cu, csrc/sw.cu)
    hand = {}
    for label, tag in (("sort", "psort_"), ("sw", "sw_kernel")):
        mine = [e for e in kernels if tag in e.name]
        hand[label] = {"device_ms": sum(e.self_device_time_total
                                        for e in mine) / 1e3,
                       "cuda_launches": len(mine)}
    return {"device_busy_ms": busy_ms, "device_kernels": len(kernels),
            "profiled_wall_ms": wall_ms, "hand_kernels": hand,
            "top_ops": [[e.key, e.self_device_time_total / 1e3, e.count]
                        for e in ops]}


if __name__ == "__main__":
    sys.exit(main())
