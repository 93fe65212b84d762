"""The port's CUDA paths on a card: the SW kernel against its plain
version, and the fused step on the card against its CPU run. These
tests need a CUDA device and skip elsewhere; they import no JAX, so
they also run where only the port's dependencies are installed:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_gpu.py
"""

import numpy as np
import pytest
import torch

from gappadder_tpu_torch.ops import sw_cuda, sw_host
from gappadder_tpu_torch.ops.sw_host import sw_test_pairs
from gappadder_tpu_torch.parallel import slice as sl

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
def test_kernel_refuses_wrong_dtype(cuda):
    q = torch.zeros(2, 4, dtype=torch.int32, device=cuda)
    ln = torch.ones(2, dtype=torch.int32, device=cuda)
    with pytest.raises(TypeError):
        sw_cuda.sw_batch_cuda(q, ln, q, ln)


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
