"""Port parity: batched DBG unitig assembly, JAX vs gappadder_tpu_torch
on the seeds of tests/test_dbg_oracle.py (with and without a forced
cycle), a bubble-popping case and an adaptive min_kmer_count case.
All five outputs (useq, ulen, count, n_nodes_raw, n_edges_raw) must be
exactly equal."""

import dataclasses

import numpy as np
import pytest
import jax.numpy as jnp
import torch

from gappadder_tpu import dna
from gappadder_tpu.ops import dbg as jdbg
from gappadder_tpu.parallel import slice as jsl
from gappadder_tpu_torch.ops import dbg as tdbg
from gappadder_tpu_torch.parallel import slice as tsl


def _rc(s):
    return dna.decode(dna.revcomp(dna.encode(s)))


def _rand(rng, n):
    return "".join(np.array(list("ACGT"))[rng.integers(0, 4, n)])


def _kstrings(seed, k, sub_k, with_cycle):
    """The k-string set of test_dbg_oracle.py for this seed."""
    rng = np.random.default_rng(seed)
    base = _rand(rng, 80)
    seqs = [base, base[20:60] + _rand(rng, 30), _rand(rng, 50)]
    if with_cycle:
        per = _rand(rng, sub_k + 2)
        seqs.append((per * 5)[:3 * sub_k + 7])
    ks = set()
    for s in seqs:
        for i in range(len(s) - k + 1):
            sub = s[i:i + k]
            ks.add(min(sub, _rc(sub)))
    return sorted(ks)


def _both(arr, n, cnt, **kw):
    a = jdbg.assemble_unitigs(jnp.asarray(arr), jnp.asarray(n),
                              None if cnt is None else jnp.asarray(cnt), **kw)
    b = tdbg.assemble_unitigs(torch.from_numpy(arr), torch.from_numpy(n),
                              None if cnt is None else torch.from_numpy(cnt),
                              **kw)
    assert len(a) == len(b)
    for x, y in zip(a, b):
        x, y = np.asarray(x), y.numpy()
        assert x.dtype == y.dtype and x.shape == y.shape
        np.testing.assert_array_equal(x, y)
    return b


@pytest.mark.parametrize("seed", [0, 1, 2, 3])
@pytest.mark.parametrize("k,sub_k", [(17, 11), (21, 15)])
@pytest.mark.parametrize("with_cycle", [False, True])
def test_assemble_matches_jax(seed, k, sub_k, with_cycle):
    ks = _kstrings(seed, k, sub_k, with_cycle)
    # gap 0 holds the set, gap 1 half of it; two padding rows
    arr = np.full((2, len(ks) + 2, k), dna.N, np.int8)
    for i, s in enumerate(ks):
        arr[:, i] = dna.encode(s)
    n = np.array([len(ks), len(ks) // 2], np.int32)
    _both(arr, n, None, k=k, sub_k=sub_k, max_unitigs=64, max_len=512,
          min_len=sub_k)
    _both(arr, n, None, k=k, sub_k=sub_k, max_unitigs=8, max_len=128,
          min_len=sub_k, node_cap=256, edge_cap=256)


@pytest.mark.parametrize("k,sub_k", [(21, 15), (33, 16)])
def test_bubble_pop_matches_jax(k, sub_k):
    """A single-SNP error variant at low coverage beside the truth at
    high coverage; two popping rounds (sub_k = 16 pads the node limbs)."""
    rng = np.random.default_rng(5)
    truth = _rand(rng, 150)
    alt = {"A": "C", "C": "G", "G": "T", "T": "A"}[truth[75]]
    err = truth[:75] + alt + truth[76:]
    kt = [truth[i:i + k] for i in range(len(truth) - k + 1)]
    ke = [s for s in (err[i:i + k] for i in range(len(err) - k + 1))
          if s not in set(kt)]
    ks = kt + ke
    arr = np.full((1, len(ks), k), dna.N, np.int8)
    for i, s in enumerate(ks):
        arr[0, i] = dna.encode(s)
    cnt = np.array([[8] * len(kt) + [1] * len(ke)], np.int32)
    n = np.array([len(ks)], np.int32)
    for rounds in (1, 2):
        _both(arr, n, cnt, k=k, sub_k=sub_k, max_unitigs=16, max_len=256,
              min_len=10, pop_bubbles=rounds, node_cap=1024, edge_cap=1024)


def test_adaptive_min_count_assembly_matches_jax():
    """The count path with min_kmer_count = -1 (adaptive error filter)
    and bubble popping, through the step's own `_distinct_kmers` and
    then the assembler."""
    jd, args = jsl.example_data(1, gaps_per_shard=2, use_pallas=False)
    jd = dataclasses.replace(jd, min_kmer_count=-1, pop_bubbles=1)
    td = tsl.dims_from_fields(dataclasses.asdict(jd))
    reads = args[22]
    rng = np.random.default_rng(1)
    rows = rng.integers(0, reads.shape[0], (2, 40))
    seq = reads[rows].copy()
    seq[0, :3, 20] = (seq[0, :3, 20] + 1) % 4          # sequencing errors
    rlen = np.full((2, 40), reads.shape[1], np.int32)
    rlen[1, 30:] = 0
    k = 17
    a = jsl._distinct_kmers(jnp.asarray(seq), jnp.asarray(rlen), k, jd)
    b = tsl._distinct_kmers(torch.from_numpy(seq), torch.from_numpy(rlen), k,
                            td)
    for x, y in zip(a, b):
        np.testing.assert_array_equal(np.asarray(x).astype(np.int64),
                                      y.numpy().astype(np.int64))
    _both(b[1].numpy(), b[2].numpy(), b[3].numpy(), k=k, sub_k=15,
          max_unitigs=4, max_len=256, min_len=40, pop_bubbles=1,
          node_cap=td.effective_node_cap(k), edge_cap=td.effective_node_cap(k))


def test_unpack_kmers_to_strings():
    rng = np.random.default_rng(2)
    limbs = rng.integers(0, 1 << 32, (2, 9, 3), dtype=np.uint64)
    limbs[0, 4] = 0xFFFFFFFF
    a = jdbg.unpack_kmers_to_strings(jnp.asarray(limbs.astype(np.uint32)), 40)
    b = tdbg.unpack_kmers_to_strings(torch.from_numpy(limbs.astype(np.int64)),
                                     40)
    np.testing.assert_array_equal(np.asarray(a), b.numpy())
