"""Port parity: the plain batched SW of gappadder_tpu_torch (the CPU path
of the CUDA kernel's wrapper) against sw_xla.sw_batch, against the
Pallas kernel in interpret mode and against the numpy oracle, in all
four modes. The kernel itself is held against the plain version in
tests/test_torch_gpu.py, which needs a CUDA device."""

import numpy as np
import pytest
import jax.numpy as jnp
import torch

from gappadder_tpu.ops import sw_pallas, sw_xla
from gappadder_tpu.ops.sw_host import SWParams as JSWParams
from gappadder_tpu_torch.ops import sw_cuda, sw_host
from gappadder_tpu_torch.ops.sw_host import sw_test_pairs as _pairs

MODES = ["local", "overlap", "fit", "extend"]
PARAMS = [(1, -4, 7, 1), (1, -1, 1, 1), (2, -3, 5, 2)]


def _plain(q, ql, t, tl, params, mode, slack):
    res = sw_cuda.sw_batch_cuda(
        torch.from_numpy(q), torch.from_numpy(ql), torch.from_numpy(t),
        torch.from_numpy(tl), sw_host.SWParams(*params), mode, slack)
    return [r.numpy() for r in res]


@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("params", PARAMS)
def test_plain_matches_sw_xla(mode, params):
    q, ql, t, tl = _pairs(10 * MODES.index(mode) + PARAMS.index(params))
    slack = 2 if mode == "overlap" else 0
    want = sw_xla.sw_batch(jnp.asarray(q), jnp.asarray(ql), jnp.asarray(t),
                           jnp.asarray(tl), JSWParams(*params), mode,
                           end_slack=slack)
    got = _plain(q, ql, t, tl, params, mode, slack)
    for g, w in zip(got, want):
        assert g.dtype == np.int32
        np.testing.assert_array_equal(g, np.asarray(w))


@pytest.mark.parametrize("mode", MODES)
def test_plain_matches_pallas_interpret(mode):
    q, ql, t, tl = _pairs(17 + len(mode), B=32)
    ql = np.maximum(ql, 1)       # the Pallas kernel's callers pass >= 1
    tl = np.maximum(tl, 1)
    slack = 3 if mode == "overlap" else 0
    params = (1, -4, 7, 1)
    want = sw_pallas.sw_batch_pallas(
        jnp.asarray(q), jnp.asarray(ql), jnp.asarray(t), jnp.asarray(tl),
        JSWParams(*params), mode, interpret=True, end_slack=slack)
    got = _plain(q, ql, t, tl, params, mode, slack)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, np.asarray(w))


@pytest.mark.parametrize("mode", MODES)
def test_plain_matches_numpy_oracle(mode):
    q, ql, t, tl = _pairs(5, B=12, Lq=10, Lt=16)
    ql = np.maximum(ql, 1)
    tl = np.maximum(tl, 1)
    params = sw_host.SWParams(1, -4, 7, 1)
    slack = 1 if mode == "overlap" else 0
    got = _plain(q, ql, t, tl, (1, -4, 7, 1), mode, slack)
    for b in range(len(q)):
        s, _, _, _ = sw_host.sw_np(q[b, :ql[b]], t[b, :tl[b]], params, mode,
                                   end_slack=slack)
        assert got[0][b] == s, b


def test_wrapper_refuses_other_devices():
    """A tensor that is neither on the CPU nor on a CUDA device is
    refused: the wrapper has no fallback."""
    q = torch.zeros(2, 4, dtype=torch.int8, device="meta")
    ln = torch.ones(2, dtype=torch.int32, device="meta")
    with pytest.raises(ValueError):
        sw_cuda.sw_batch_cuda(q, ln, q, ln)
