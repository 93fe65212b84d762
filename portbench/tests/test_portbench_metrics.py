"""The roofline arithmetic on hand-worked shapes, the reduction of a
profiler record to busy time, idle gaps and each wrapped call's device
time, and the readers on a hand-made record."""

import types

import pytest

from portbench.harness import trace
from portbench.metrics import _roofline, _shares


def test_sort_bytes_read_and_write_each_plane_once():
    # 3 int64 planes of 1000 rows and one int32 plane: 2 x (24000 + 4000)
    assert _roofline.sort_bytes([(1000, 8)] * 3 + [(1000, 4)]) == 56_000
    assert _roofline.sort_least_s(3.35e12) == pytest.approx(1.0)


def test_sw_counts_live_cells_only():
    # two live pairs 300 x 500 and 10 x 7; a length of 1 is a placeholder
    assert _roofline.sw_live_cells([300, 10, 300, 1], [500, 7, 1, 800]) \
        == 300 * 500 + 70


def test_sw_least_time_at_the_issue_ceiling():
    # 132 SMs at 1980 MHz issue 4 x 32 x 132 x 1.98e9 lane instructions
    ceiling = _roofline.issue_ceiling(132, 1.98e9)
    assert ceiling == pytest.approx(33_454_080e6)
    cells = 262_598_400
    want = cells * 3 / ceiling
    assert _roofline.sw_least_s(cells, 132, 1.98e9) == pytest.approx(want)
    # the smoke table's 11 int32 operations over 128 lanes an SM a clock
    # gave 0.0863 ms for these cells; the least form is 3 / 11 of it
    assert want * 1e3 == pytest.approx(0.0863 * 3 / 11, rel=1e-2)


def test_share_is_none_without_device_time():
    assert _roofline.share(1.0, 0.0) is None
    assert _roofline.share(1.0, 4.0) == 25.0


def ev(dev, s, e, name, corr=0, linked=0, tid=1):
    if dev:
        act = "gpu_memcpy" if name.startswith("Memcpy") else "kernel"
    else:
        act = "cuda_runtime" if name.startswith("cuda") else \
            "user_annotation" if name.startswith(trace.RANGE) else "cpu_op"
    return (act, s, e, name, corr, linked, tid)


def record():
    """A window of 1000 ns: a sort call (two kernels, one launched by an
    aten op inside it, one by its runtime call) and an SW call (one
    kernel), an aten op outside both, and the host busy in between."""
    return [
        ev(False, 0, 1000, trace.WINDOW, corr=1),
        ev(False, 100, 300, trace.RANGE + "sort", corr=2),
        ev(False, 110, 120, "aten::empty", corr=3),
        ev(False, 200, 210, "cudaLaunchKernel", corr=90),
        ev(False, 500, 600, trace.RANGE + "sw", corr=4),
        ev(False, 510, 520, "cudaLaunchKernel", corr=91),
        ev(False, 700, 900, "aten::item", corr=5),
        ev(False, 705, 710, "cudaLaunchKernel", corr=92),
        ev(True, 150, 250, "fill_kernel", corr=80, linked=3, tid=0),
        ev(True, 250, 400, "psort_tiles", corr=90, linked=2, tid=0),
        ev(True, 550, 650, "sw_kernel", corr=91, linked=4, tid=0),
        ev(True, 720, 760, "Memcpy DtoH", corr=92, linked=5, tid=0),
        # the device-side copy of a range is not a device operation
        ("gpu_user_annotation", 100, 900, "portbench::sort", 0, 0, 0),
    ]


def test_reduction_of_a_hand_made_record():
    s = trace.reduce_events(record(), ("sort", "sw"))
    assert s.window_s == pytest.approx(1000e-9)
    # busy: [150, 400) + [550, 650) + [720, 760)
    assert s.busy_s == pytest.approx(390e-9)
    assert s.kernels == 3
    assert s.call_device_s["sort"] == [pytest.approx(250e-9)]
    assert s.call_device_s["sw"] == [pytest.approx(100e-9)]
    assert s.unattributed_kernels == 0
    ops = dict(s.device_ops)
    assert ops["portbench::sort"] == pytest.approx(150e-9)
    assert ops["aten::empty"] == pytest.approx(100e-9)
    # idle [0, 150), [400, 550), [650, 720) with no op open at their
    # middles; [760, 1000) inside aten::item
    idle = dict(s.idle_gaps)
    assert idle["portbench::window / host"] == pytest.approx(370e-9)
    assert idle["portbench::window / aten::item"] == pytest.approx(240e-9)


def test_readers_on_a_hand_made_record():
    s = trace.reduce_events(record(), ("sort", "sw"))
    calls = [trace.Call("sort", [(100, 8), (100, 8)]),
             trace.Call("sw", ([300], [500]))]
    ctx = types.SimpleNamespace(trace=s, calls=calls, sms=132,
                                max_sm_clock_hz=1.98e9, traced_units=2,
                                units=[{"wall_s": 2.0}, {"wall_s": 4.0}])
    assert _shares.idle_share(ctx) == pytest.approx(61.0)
    sort = _roofline.kernel_share(ctx, "sort")
    assert sort == pytest.approx(100 * (3200 / 3.35e12) / 250e-9)
    sw = _roofline.kernel_share(ctx, "sw")
    assert sw == pytest.approx(100 * _roofline.sw_least_s(
        150_000, 132, 1.98e9) / 100e-9)
    # no trace, or no device time: nothing to read
    empty = types.SimpleNamespace(trace=None, calls=[], units=[])
    assert _shares.idle_share(empty) is None
    assert _roofline.kernel_share(empty, "sort") is None
