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
from gappadder_tpu_torch.testcases import (SW_EDGE_SHAPES, SW_STRIP_SHAPES,
                                           sw_edge_pairs, sw_strip_pairs)
from gappadder_tpu_torch.testcases import sw_test_pairs as _pairs


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """One intra-op thread: the plain DPs run thousands of small tensor
    steps, which a pool of threads does not speed up, and the pool's
    waiting threads slow the other test workers on the same cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


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


def _ragged_pairs(seed, n=12, max_q=100, max_t=120):
    """Ragged query/target lists over two query-length buckets, each
    target holding a mutated copy of part of its query."""
    rng = np.random.default_rng(seed)
    qs, ts = [], []
    for _ in range(n):
        q = rng.integers(0, 4, int(rng.integers(1, max_q))).astype(np.int8)
        t = rng.integers(0, 4, int(rng.integers(1, max_t))).astype(np.int8)
        k = min(len(q), len(t)) // 2
        if k >= 2:
            off = int(rng.integers(0, len(t) - k + 1))
            t[off:off + k] = q[:k]
            t[off + k // 2] = (t[off + k // 2] + 1) % 4
        qs.append(q)
        ts.append(t)
    return qs, ts


@pytest.mark.parametrize("mode", ["local", "fit"])
def test_swutil_matches_jax(mode):
    """Pick's bucketed dispatch (`sw_ragged` over `sw_pairs`), on the
    CPU, against the JAX package's on its XLA path."""
    from gappadder_tpu.ops import swutil as jswutil
    from gappadder_tpu.ops.sw_host import BWA_PARAMS as JBWA
    from gappadder_tpu_torch.ops import swutil
    qs, ts = _ragged_pairs(3 + len(mode))
    want = jswutil.sw_ragged(qs, ts, JBWA, mode, use_pallas=False)
    got = swutil.sw_ragged(qs, ts, sw_host.BWA_PARAMS, mode, device="cpu")
    for g, w in zip(got, want):
        assert g.dtype == w.dtype
        np.testing.assert_array_equal(g, w)
    if mode == "local":
        assert (got[0] > 0).all()


@pytest.mark.parametrize("shape", SW_EDGE_SHAPES,
                         ids=lambda s: f"{s[0]}x{s[1]}x{s[2]}")
def test_plain_matches_sw_xla_at_band_edges(shape):
    """The query widths and short targets the card holds the kernel to
    (`testcases.SW_EDGE_SHAPES`), one mode each, against sw_xla."""
    B, Lq, Lt = shape
    mode = MODES[SW_EDGE_SHAPES.index(shape) % 4]
    q, ql, t, tl = sw_edge_pairs(Lq + Lt, B, Lq, Lt)
    slack = 2 if mode == "overlap" else 0
    want = sw_xla.sw_batch(jnp.asarray(q), jnp.asarray(ql), jnp.asarray(t),
                           jnp.asarray(tl), JSWParams(2, -3, 5, 2), mode,
                           end_slack=slack)
    got = _plain(q, ql, t, tl, (2, -3, 5, 2), mode, slack)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, np.asarray(w))


@pytest.mark.parametrize("Lq", [1, 32, 33, 300, 320, 321, 1024, 1025, 2048,
                                2055])
def test_cell_slots_counts_the_kernel_sweep(Lq):
    """cell_slots equals a cell-by-cell count of the kernel's schedule:
    32 lanes of R rows stepping through every column of the pair, from
    the first lane's first column to the last live lane's last, once
    for each strip of 32 R rows."""
    R = sw_cuda.rows_per_lane(Lq)
    if Lq <= 32 * 32:
        assert 32 * R >= Lq and (R == sw_cuda.ROWS_PER_LANE[0]
                                 or 32 * sw_cuda.ROWS_PER_LANE[
                                     sw_cuda.ROWS_PER_LANE.index(R) - 1] < Lq)
    else:
        assert R == 32 and sw_cuda.strips(Lq) == -(-Lq // 1024)
    Lt = 50
    ql = np.array([0, 1, Lq, max(Lq - 7, 1), Lq, Lq], np.int32)
    tl = np.array([5, 9, 0, Lt, 1, 31], np.int32)
    want = 0
    for q, t in zip(ql, tl):
        for base in range(0, int(q) if t > 0 else 0, 32 * R):
            last_lane = (min(q - base, 32 * R) - 1) // R
            want += 32 * R * (t + last_lane)
    assert sw_cuda.cell_slots(torch.from_numpy(ql), torch.from_numpy(tl),
                              Lq, Lt) == want


@pytest.mark.parametrize("mode", MODES)
def test_plain_matches_sw_xla_past_one_strip(mode):
    """Queries longer than the kernel's 1024-row strip (whole contigs,
    as the merge's screens send them), with ties on both sides of the
    strip edge, against sw_xla in all four modes; overlap mode with an
    end slack that spans the strips."""
    B, Lq, Lt = SW_STRIP_SHAPES[1]
    q, ql, t, tl = sw_strip_pairs(7, B, Lq, Lt)
    slack = 1100 if mode == "overlap" else 0
    want = sw_xla.sw_batch(jnp.asarray(q), jnp.asarray(ql), jnp.asarray(t),
                           jnp.asarray(tl), JSWParams(1, -4, 7, 1), mode,
                           end_slack=slack)
    got = _plain(q, ql, t, tl, (1, -4, 7, 1), mode, slack)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, np.asarray(w))
