"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Builds the hand-written kernels from `gappadder_tpu_torch/csrc/`,
holds each against its plain PyTorch version on the card, drives the
port's main path (the fused collect->assemble->pick step,
`gappadder_tpu_torch.parallel.slice.run_step`) at the toy size and at
the production size (64 gaps, six (k, sub_k) settings, 300 bp flanks,
100 bp reads, 100-1000 bp gaps), checks its outputs, fires the
capacity checks, and times the step and the kernels with CUDA events.

Prints JSON lines along the way; the line before the last is the
`kernels` record and the last line is
{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}.
Any failed phase raises, so the exit code is non-zero and no result
line is printed. Exits non-zero at once when no CUDA device is present.
"""

from __future__ import annotations

import dataclasses
import gc
import json
import os
import subprocess
import sys
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
    """Kernel vs plain on the card; returns the max abs difference."""
    args = [torch.from_numpy(x).to(dev) for x in (q, ql, t, tl)]
    got = sw_cuda.sw_batch_cuda(*args, params, mode, slack)
    want = sw_cuda.sw_batch_plain(*args, params, mode, slack)
    err = max(int((g.long() - w.long()).abs().max())
              for g, w in zip(got, want))
    if err:
        raise AssertionError(f"sw kernel != plain: mode={mode} "
                             f"params={params} slack={slack} err={err}")
    return err


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    from gappadder_tpu_torch.ops import cuda_build, sw_cuda
    from gappadder_tpu_torch.ops.sw_host import (BWA_PARAMS, SWParams,
                                                 sw_test_pairs)
    from gappadder_tpu_torch.parallel import slice as sl

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
    for name, log in reports.items():
        print(f"[nvcc {name}]\n{log}", file=sys.stderr)

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
    q, ql, t, tl = sw_test_pairs(n_checks, 6144, 300, 2048)
    max_err = max(max_err, check_sw(sw_cuda, q, ql, t, tl,
                                    BWA_PARAMS, "local", 0, dev))
    n_checks += 1
    emit(phase="sw_check", cases=n_checks, max_abs_err=max_err,
         production_shape=[6144, 300, 2048])

    # ---- phase 3: toy step on the card == the port's CPU run ---------------
    dims, args = sl.example_data(1, gaps_per_shard=2)
    gpu = [o.cpu().numpy() for o in sl.run_step(dims, args)]
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
    emit(phase="toy_step", outputs_equal_cpu=True, closure=True)

    # ---- phase 4: the production step --------------------------------------
    pdims, pargs = sl.example_data(1, **PRODUCTION)
    pin = sl.inputs_from_numpy(pargs, dev)
    sw_cuda.launches = 0
    out = sl.run_step(pdims, pin)
    torch.cuda.synchronize()
    sw_launches = sw_cuda.launches
    if sw_launches < 1:
        raise AssertionError("production step did not launch the SW kernel")
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
    emit(phase="production_step", n_gaps=pdims.n_gaps,
         counts=counts.tolist(), sw_launches=sw_launches,
         sw_batch=list(pq.shape) + [pt.shape[1]], block4_equal_plain=True)

    # ---- phase 5: undersized caps fire check_overflow ----------------------
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

    # ---- phase 6: times ----------------------------------------------------
    step = lambda: sl.run_step(pdims, pin)
    step()                                               # warm-up
    emit(phase="host", cpu_count=os.cpu_count(), loadavg=os.getloadavg(),
         torch_threads=torch.get_num_threads(), smi=card)
    windows = [step_window(step, STEPS_PER_WINDOW) for _ in range(N_WINDOWS)]
    gc.collect()
    gc.disable()
    try:
        nogc = [step_window(step, STEPS_PER_WINDOW) for _ in range(N_WINDOWS)]
    finally:
        gc.enable()
    single = [step_window(step, 1) for _ in range(5)]
    per_step = sorted(w["ms_per_step"] for w in windows)
    step_ms = per_step[len(per_step) // 2]
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
         nogc_window_ms_per_step=col(nogc, "ms_per_step"),
         nogc_window_host_probe_ms=col(nogc, "host_probe_ms"),
         single_step_ms=col(single, "ms_per_step"),
         single_issue_ms=col(single, "issue_ms_per_step"),
         single_host_probe_ms=col(single, "host_probe_ms"),
         host_syncs_per_step=syncs, loadavg=os.getloadavg(), smi=card)

    Lq, Lt = pq.shape[1], pt.shape[1]
    qrows = torch.clamp(pql, max=Lq).long()
    cells = int((qrows * torch.clamp(ptl, max=Lt).long()).sum())
    live_flat = live.reshape(-1)
    live_cells = int((qrows * ptl.long())[live_flat].sum())
    kern_fn = lambda: sw_cuda.sw_batch_cuda(pq, pql, pt, ptl, BWA_PARAMS,
                                            "local")
    kern_fn()
    sw_ms = cuda_ms(kern_fn, 5)
    plain_ms = cuda_ms(lambda: sw_cuda.sw_batch_plain(
        pq, pql, pt, ptl, BWA_PARAMS, "local"), 1)
    B = pq.shape[0]
    ops_s = props.multi_processor_count * 64 * sm_clock_mhz * 1e6
    ops_ms = live_cells * SW_OPS_PER_CELL / ops_s * 1e3
    bytes_ms = (B * (Lq + Lt) + 8 * B + 12 * B) / HBM_BYTES_PER_S * 1e3
    bound_ms = max(ops_ms, bytes_ms)
    emit(phase="sw_time", sw_ms=sw_ms, plain_ms=plain_ms, pairs=B,
         cells=cells, live_cells=live_cells,
         gcups_live=live_cells / (sw_ms / 1e3) / 1e9,
         gcups_all=cells / (sw_ms / 1e3) / 1e9,
         bound_ms=bound_ms, bound_ops_ms=ops_ms, bound_bytes_ms=bytes_ms,
         smi=card)

    # per-block breakdown and device busy share of the production step
    block_times(sl, pdims, pin)                          # warm-up
    runs = [block_times(sl, pdims, pin) for _ in range(3)]
    blocks = {k: sorted(r[k] for r in runs)[1] for k in runs[0]}
    emit(phase="step_blocks", **blocks, sum_ms=sum(blocks.values()),
         runs=runs, smi=card)
    prof = profile_step(sl, pdims, pin)
    emit(phase="step_profile", **prof,
         busy_share=prof["device_busy_ms"] / prof["profiled_wall_ms"],
         smi=card)

    emit(kernels=[{
        "name": "sw_batch_cuda", "route": "cuda",
        "source": "gappadder_tpu_torch/csrc/sw.cu",
        "replaces": "gappadder_tpu/ops/sw_pallas.py:242",
        "launches": sw_launches, "max_abs_err": float(max_err),
        "ms": sw_ms, "plain_ms": plain_ms, "bound_ms": bound_ms,
        "bound_by": "operations" if ops_ms >= bytes_ms else "bytes",
        "library_ms": None, "check": "exact equality with sw_batch_plain"}])
    print(card, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


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


def profile_step(sl, dims, a, top: int = 10):
    """One production step under torch.profiler: the summed duration of
    its device kernels (one stream, so they do not overlap), their
    count, the profiled wall time, and the torch operators with the
    most device time."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        sl.run_step(dims, a)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    kernels = [e for e in prof.events() if e.device_type == DeviceType.CUDA]
    busy_ms = sum(e.self_device_time_total for e in kernels) / 1e3
    ops = sorted((e for e in prof.key_averages()
                  if e.key.startswith("aten::")),
                 key=lambda e: e.self_device_time_total, reverse=True)[:top]
    return {"device_busy_ms": busy_ms, "device_kernels": len(kernels),
            "profiled_wall_ms": wall_ms,
            "top_ops": [[e.key, e.self_device_time_total / 1e3, e.count]
                        for e in ops]}


if __name__ == "__main__":
    sys.exit(main())
