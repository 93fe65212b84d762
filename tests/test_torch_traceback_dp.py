"""Pick's traceback wrapper (`ops/traceback_dp.py`) on the CPU: the
ragged pack of a pass's winners that the card path launches on, the
dispatch by device (the CPU's answer is `sw_host.alignment_stats_batch`,
unchanged) and the kernel path's refusals. The kernel's
own logic is held to the host in tests/test_torch_kernel_emulation.py,
on the card in tests/test_torch_gpu.py."""

import numpy as np
import pytest
import torch

from gappadder_tpu_torch.ops import cuda_build, sw_host, traceback_dp
from gappadder_tpu_torch.testcases import traceback_winners


def test_pack_keeps_each_winner_up_to_its_end_cell():
    """Winners longest first (qend * tend), each query cut at its qend
    and target at its tend, empty ones kept empty, a scratch row of 8
    int32 a column only past 512 query rows."""
    rng = np.random.default_rng(0)
    q = rng.integers(0, 4, (5, 600)).astype(np.int8)
    t = rng.integers(0, 4, (5, 90)).astype(np.int8)
    qend = np.array([30, 0, 513, 512, 7])
    tend = np.array([20, 9, 40, 90, 0])
    pack = traceback_dp.pack_winners(q, t, qend, tend)
    assert pack.order.tolist() == [3, 2, 0, 1, 4]
    for k, b in enumerate(pack.order):
        qk, tk = pack.pair(k)
        np.testing.assert_array_equal(qk, q[b, :qend[b]])
        np.testing.assert_array_equal(tk, t[b, :tend[b]])
    assert pack.meta[:, 4].tolist() == [-1, 0, -1, -1, -1]
    assert pack.scratch_len == 8 * 40


@pytest.mark.parametrize("mode", ["local", "fit"])
def test_cpu_path_is_the_host_traceback(mode):
    q, ql, t, tl, qend, tend = traceback_winners(4, mode, rows=(33, 300),
                                                 tiny=20, mid=5, dels=5)
    got = traceback_dp.alignment_stats_device(
        q, ql, t, tl, sw_host.BWA_PARAMS, mode, qend, tend, device="cpu")
    want = sw_host.alignment_stats_batch(q, ql, t, tl, sw_host.BWA_PARAMS,
                                         mode, qend, tend)
    for g, w in zip(got, want):
        assert g.dtype == w.dtype
        np.testing.assert_array_equal(g, w)


def test_card_path_launches_the_kernel_or_raises(monkeypatch):
    """A CUDA device never falls back to the host traceback: where the
    kernel cannot be built or loaded, the call raises; a mode other than
    Pick's two is refused before any launch."""
    def no_kernel(name):
        raise RuntimeError(f"nvcc not found ({name})")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(cuda_build, "load", no_kernel)
    q, ql, t, tl, qend, tend = traceback_winners(1, "local", rows=(40,),
                                                 tiny=3, mid=0, dels=0)
    before = traceback_dp.launches
    with pytest.raises(RuntimeError, match="nvcc not found"):
        traceback_dp.alignment_stats_device(q, ql, t, tl, sw_host.BWA_PARAMS,
                                            "local", qend, tend,
                                            device="cuda")
    with pytest.raises(ValueError, match="overlap"):
        traceback_dp.launch(None, 1, None, None, sw_host.BWA_PARAMS,
                            "overlap")
    assert traceback_dp.launches == before
