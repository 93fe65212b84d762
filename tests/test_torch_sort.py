"""Port parity: gappadder_tpu_torch.ops.psort.bitonic_sort against
`lax.sort` on the cases of tests/test_psort.py, and the port's plain
sort (the version CPU tensors take) against the JAX package's Pallas
bitonic kernel `_bitonic_call`, run in interpret mode with the stable
index tie-break. The port's sort is stable, so payloads are compared in
full against `is_stable=True`."""

import numpy as np
import pytest
import jax
import jax.numpy as jnp
import torch

from gappadder_tpu.ops import psort as jpsort
from gappadder_tpu_torch.ops import psort
from gappadder_tpu_torch.testcases import SORT_CASES, sort_case


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


def _pallas(ops, num_keys):
    res = jpsort.bitonic_sort(tuple(jnp.asarray(o) for o in ops),
                              num_keys=num_keys, stable=True, interpret=True)
    return [np.asarray(r).astype(np.int64) for r in res]


@pytest.mark.parametrize("shape,nl,npay,signed", [
    ((2, 300), 1, 1, False), ((3, 517), 2, 0, False), ((2, 257), 3, 1, False),
    ((1, 1000), 4, 2, False), ((2, 300), 1, 2, True), ((2, 129), 2, 1, True),
    ((700,), 2, 1, False)])
def test_plain_matches_pallas_kernel(shape, nl, npay, signed):
    """uint32 limbs (FULL mixed in) or signed int32 keys, held in int64
    on the port's side, 1-4 keys, N not a power of two."""
    rng = np.random.default_rng(sum(shape) + 10 * nl + npay)
    if signed:
        keys = [rng.integers(-40, 40, shape).astype(np.int32)
                for _ in range(nl)]
    else:
        pool = rng.integers(0, 1 << 32, 16, dtype=np.uint32)
        keys = [pool[rng.integers(0, 16, shape)] for _ in range(nl)]
        keys[0][rng.random(shape) < 0.25] = 0xFFFFFFFF
    pays = [rng.integers(-1000, 1000, shape).astype(np.int32)
            for _ in range(npay)]
    ops = keys + pays
    want = _pallas(ops, nl)
    got = psort.bitonic_sort_plain(
        tuple(torch.from_numpy(o.astype(np.int64)) for o in ops), nl)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), w)


@pytest.mark.parametrize("case", ["k2p1", "n0", "n1", "n127", "all_full",
                                  "all_ties", "negative"])
def test_plain_matches_lax_sort_on_kernel_cases(case):
    """The cases the card holds the kernel to, at their CPU-sized
    shapes, against lax.sort(is_stable=True)."""
    planes, nk = sort_case(case, seed=3)
    got = psort.bitonic_sort(tuple(torch.from_numpy(p) for p in planes), nk)
    # the JAX side holds keys as uint32 (limbs) or int32 (signed)
    as32 = [p.astype(np.uint32 if i < nk and p.min(initial=0) >= 0
                     else np.int32) for i, p in enumerate(planes)]
    for g, w in zip(got, _oracle(as32, nk)):
        assert g.dtype == torch.int64
        np.testing.assert_array_equal(g.numpy(), w)


def test_sort_refuses_non_int64_planes():
    with pytest.raises(TypeError):
        psort.bitonic_sort((torch.zeros(4, dtype=torch.int32),), 1)
    with pytest.raises(ValueError):
        psort.bitonic_sort((torch.zeros(4, dtype=torch.int64),), 2)


@pytest.mark.parametrize("case", [n for n in SORT_CASES
                                  if n.startswith(("wide_tile", "narrow_tile",
                                                   "row_"))])
def test_plain_matches_lax_sort_on_tile_edge_cases(case):
    """The cases around the kernel's tile sizes, at their full shapes,
    against lax.sort(is_stable=True)."""
    planes, nk = sort_case(case, seed=len(case))
    got = psort.bitonic_sort(tuple(torch.from_numpy(p) for p in planes), nk)
    as32 = [p.astype(np.uint32 if i < nk else np.int32)
            for i, p in enumerate(planes)]
    for g, w in zip(got, _oracle(as32, nk)):
        np.testing.assert_array_equal(g.numpy(), w)
