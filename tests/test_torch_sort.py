"""Port parity: gappadder_tpu_torch.ops.psort.bitonic_sort against
`lax.sort` on the cases of tests/test_psort.py. The port's sort is
stable, so payloads are compared in full against `is_stable=True`."""

import numpy as np
import pytest
import jax
import jax.numpy as jnp
import torch

from gappadder_tpu_torch.ops import psort


def _oracle(ops, num_keys):
    res = jax.lax.sort(tuple(jnp.asarray(o) for o in ops),
                       dimension=ops[0].ndim - 1, num_keys=num_keys,
                       is_stable=True)
    return [np.asarray(r).astype(np.int64) for r in res]


def _run(ops, num_keys, stable=False):
    res = psort.bitonic_sort(
        tuple(torch.from_numpy(o.astype(np.int64)) for o in ops),
        num_keys=num_keys, stable=stable)
    return [r.numpy() for r in res]


@pytest.mark.parametrize("B,N,nl", [(3, 2048, 1), (2, 2048, 2),
                                    (1, 4096, 4), (4, 257, 2)])
def test_keys_match_lax_sort(B, N, nl):
    rng = np.random.default_rng(B * 1000 + N + nl)
    ops = [rng.integers(0, 50, (B, N)).astype(np.uint32) for _ in range(nl)]
    pay = np.tile(np.arange(N, dtype=np.int32), (B, 1))
    for g, w in zip(_run(ops + [pay], nl), _oracle(ops + [pay], nl)):
        np.testing.assert_array_equal(g, w)


@pytest.mark.parametrize("stable", [False, True])
def test_payload_follows_keys(stable):
    rng = np.random.default_rng(7)
    B, N = 2, 2048
    keys = rng.integers(0, 100, (B, N)).astype(np.uint32)
    pay = np.tile(np.arange(N, dtype=np.int32), (B, 1))
    for g, w in zip(_run([keys, pay], 1, stable), _oracle([keys, pay], 1)):
        np.testing.assert_array_equal(g, w)


def test_signed_int32_keys():
    rng = np.random.default_rng(9)
    B, N = 2, 2048
    keys = rng.integers(-1000, 1000, (B, N)).astype(np.int32)
    pay = np.tile(np.arange(N, dtype=np.int32), (B, 1))
    for g, w in zip(_run([keys, pay], 1), _oracle([keys, pay], 1)):
        np.testing.assert_array_equal(g, w)


def test_full_range_uint32_keys():
    rng = np.random.default_rng(3)
    B, N = 2, 2048
    k1 = rng.integers(0, 1 << 32, (B, N), dtype=np.uint32)
    k2 = rng.integers(0, 1 << 32, (B, N), dtype=np.uint32)
    k1[:, ::7] = 0xFFFFFFFF                 # the FULL sentinel sorts last
    pay = rng.integers(0, 1 << 32, (B, N), dtype=np.uint32)
    for g, w in zip(_run([k1, k2, pay], 2), _oracle([k1, k2, pay], 2)):
        np.testing.assert_array_equal(g, w)


def test_one_dim_and_small_n():
    rng = np.random.default_rng(5)
    keys = rng.integers(0, 100, (4, 64)).astype(np.uint32)
    np.testing.assert_array_equal(_run([keys], 1)[0], np.sort(keys, axis=1))
    flat = rng.integers(-5, 5, 300).astype(np.int32)
    pay = np.arange(300, dtype=np.int32)
    for g, w in zip(_run([flat, pay], 1), _oracle([flat, pay], 1)):
        np.testing.assert_array_equal(g, w)
