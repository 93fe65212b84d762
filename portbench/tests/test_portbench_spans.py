"""The program's spans in a profiler record (`harness/spans.py`) on a
hand-made record: nested spans, an idle gap split at a span's edge,
blocking and non-blocking runtime calls; and the traced section's
Summary, which reads the same with the program's ranges in the record
but for the names of its idle gaps."""

import dataclasses

import pytest

from portbench.harness import spans, trace
from portbench.tests.test_portbench_metrics import record


def program(s, e, name, corr):
    return ("user_annotation", s, e, spans.PROGRAM + name, corr, 0, 1)


def runtime(s, e, name, corr):
    return ("cuda_runtime", s, e, name, corr, 0, 1)


def with_spans():
    """The metrics test's record (window [0, 1000), busy [150, 400),
    [550, 650), [720, 760)) with three program spans, their device copies
    and three runtime calls that launch nothing."""
    return record() + [
        program(50, 650, "outer", 10),
        program(100, 450, "inner", 11),
        program(680, 950, "tail", 12),
        # what the device side of the ranges looks like: not operations
        ("gpu_user_annotation", 150, 400, spans.PROGRAM + "inner", 0, 0, 0),
        runtime(300, 305, "cudaMemcpyAsync", 94),
        runtime(460, 470, "cudaMemcpy", 95),
        runtime(800, 890, "cudaStreamSynchronize", 93),
    ]


def test_spans_of_a_hand_made_record():
    got = spans.reduce_spans(with_spans())
    assert set(got) == {"outer", "inner", "tail"}
    # inner [100, 450]: the fill kernel (launched at 110 by aten::empty)
    # and the sort's tiles (launched at 200); idle [100, 150) of the gap
    # [0, 150) and [400, 450) of the gap [400, 550), each split at the
    # span's edge; the async copy does not block
    assert got["inner"] == spans.SpanStats(
        calls=1, wall_s=pytest.approx(350e-9), self_s=pytest.approx(350e-9),
        kernels=2, device_s=pytest.approx(250e-9),
        idle_s=pytest.approx(100e-9), syncs=0)
    # outer [50, 650]: inner's and the SW kernel (launched at 510); idle
    # [50, 150) and [400, 550); the blocking copy at 460
    assert got["outer"] == spans.SpanStats(
        calls=1, wall_s=pytest.approx(600e-9), self_s=pytest.approx(250e-9),
        kernels=3, device_s=pytest.approx(350e-9),
        idle_s=pytest.approx(250e-9), syncs=1)
    # tail [680, 950]: the copy (launched at 705) is no kernel; idle
    # [680, 720) of the gap [650, 720) and [760, 950); one stream sync
    assert got["tail"] == spans.SpanStats(
        calls=1, wall_s=pytest.approx(270e-9), self_s=pytest.approx(270e-9),
        kernels=0, device_s=pytest.approx(40e-9),
        idle_s=pytest.approx(230e-9), syncs=1)
    assert spans.table(got)["tail"]["syncs"] == 1


def test_calls_of_one_name_add_up():
    rec = record() + [program(0, 100, "a", 10), program(140, 260, "a", 11)]
    got = spans.reduce_spans(rec)["a"]
    assert got.calls == 2
    assert got.wall_s == pytest.approx(220e-9)
    # the fill kernel launched at 110 lies in neither call; the tiles at
    # 200 in the second; idle [0, 100) and [140, 150)
    assert (got.kernels, got.idle_s) == (1, pytest.approx(110e-9))


def test_no_program_spans():
    assert spans.reduce_spans(record()) == {}


@pytest.mark.parametrize("name,blocking", [
    ("cudaStreamSynchronize", True), ("cudaDeviceSynchronize", True),
    ("cudaEventSynchronize", True), ("cudaMemcpy", True),
    ("cudaMemcpy2D", True), ("cudaMemcpyAsync", False),
    ("cudaLaunchKernel", False), ("cudaStreamWaitEvent", False)])
def test_blocking_runtime_calls(name, blocking):
    assert spans.blocks(name) is blocking


def test_summary_reads_the_same_with_program_ranges():
    """Every field of the traced section's Summary, which the accepted
    readers read, is what it was without the program's ranges; only the
    labels of the idle gaps may name a program span, and their total is
    unchanged."""
    old = trace.reduce_events(record(), ("sort", "sw"))
    new = trace.reduce_events(with_spans(), ("sort", "sw"))
    for f in dataclasses.fields(trace.Summary):
        if f.name != "idle_gaps":
            assert getattr(new, f.name) == getattr(old, f.name), f.name
    assert sum(v for _n, v in new.idle_gaps) == \
        pytest.approx(sum(v for _n, v in old.idle_gaps))
    assert any("gappadder::" in n for n, _v in new.idle_gaps)
