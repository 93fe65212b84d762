"""Port parity of the seed matcher (`ops/seedmatch.py`): the k-mer index,
the sort-merge join with its fixed fanout and the vote, on the CPU,
against the JAX package's on the same numpy inputs, exactly.

The join keeps the LAST `fanout` index rows of each k-mer, so for a
k-mer that occurs more often than that in the index, which contigs get
votes depends on how the index sort orders equal keys. The port's sort
is stable; `lax.sort` on the JAX package's CPU backend keeps the input
order of equal keys at these shapes too, and the repeated-k-mer case
below holds the two packages equal where a repeat occurs 9 times."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gappadder_tpu.ops import seedmatch as jsm
from gappadder_tpu_torch import dna
from gappadder_tpu_torch.ops import seedmatch

K = 19


def _scenario(rng, n_contigs=6, L=300, n_reads=24, repeat=0):
    """Random contigs (ragged, N-padded, one with an N inside), reads
    drawn from them on both strands with a few errors, plus unrelated
    reads. With `repeat`, one 30-base motif is planted at `repeat`
    places across the contigs and into every fourth read."""
    seqs = rng.integers(0, 4, (n_contigs, L)).astype(np.int8)
    lens = rng.integers(L // 2, L + 1, n_contigs).astype(np.int32)
    lens[0] = L
    for c in range(n_contigs):
        seqs[c, lens[c]:] = dna.N
    seqs[1, 40] = dna.N
    motif = rng.integers(0, 4, 30).astype(np.int8)
    for i in range(repeat):
        c = i % n_contigs
        p = 5 + (i // n_contigs) * 60
        seqs[c, p:p + 30] = motif
    reads = np.full((n_reads, 100), dna.N, np.int8)
    rlens = np.zeros(n_reads, np.int32)
    for i in range(n_reads):
        c = int(rng.integers(0, n_contigs))
        ln = int(rng.integers(60, 101))
        if i % 6 == 5:
            frag = rng.integers(0, 4, ln).astype(np.int8)
        else:
            p = int(rng.integers(0, max(lens[c] - ln, 1)))
            frag = seqs[c, p:p + ln].copy()
            frag[rng.random(len(frag)) < 0.01] = 0
        if repeat and i % 4 == 0:
            frag = frag.copy()
            frag[10:40] = motif[:len(frag[10:40])]
        if i % 2:
            frag = dna.revcomp(frag)
        reads[i, :len(frag)] = frag
        rlens[i] = len(frag)
    return seqs, lens, reads, rlens


def _both(seqs, lens, reads, rlens, fanout=4):
    t = [torch.from_numpy(x) for x in (seqs, lens, reads, rlens)]
    idx = seedmatch.build_index(t[0], t[1], K)
    got = seedmatch.match_candidates(t[2], t[3], idx["limbs"], idx["contig"],
                                     k=K, fanout=fanout,
                                     index_pos=idx["pos"])
    jidx = jsm.build_index(seqs, lens, K)
    want = jsm.match_candidates(jnp.asarray(reads), jnp.asarray(rlens),
                                jidx["limbs"], jidx["contig"], k=K,
                                fanout=fanout, index_pos=jidx["pos"])
    return idx, jidx, got, want


@pytest.mark.parametrize("repeat", [0, 9])
def test_build_index_and_join_match_jax(rng, repeat):
    seqs, lens, reads, rlens = _scenario(rng, repeat=repeat)
    idx, jidx, got, want = _both(seqs, lens, reads, rlens)
    np.testing.assert_array_equal(idx["limbs"].numpy(),
                                  np.asarray(jidx["limbs"]).astype(np.int64))
    for k in ("contig", "pos"):
        assert idx[k].dtype == torch.int32
        np.testing.assert_array_equal(idx[k].numpy(), np.asarray(jidx[k]))
    for g, w in zip(got, want):
        assert g.dtype == torch.int32
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    votes = seedmatch.vote_pairs(got[0], 2, diag_votes=got[1])
    assert votes == jsm.vote_pairs(want[0], 2, diag_votes=want[1])
    assert seedmatch.vote_pairs(got[0], 1) == jsm.vote_pairs(want[0], 1)
    assert len(votes) >= 10
    if repeat:
        # the motif's k-mers occur `repeat` times, more than the fanout
        # of 4: the join keeps four of them, the same four in both
        lim = idx["limbs"].numpy()
        _, counts = np.unique(lim[idx["contig"].numpy() >= 0], axis=0,
                              return_counts=True)
        assert counts.max() == repeat
        assert (got[0].numpy() >= 0).sum(axis=-1).max() == 4


def test_join_with_wider_fanout_and_unrelated_reads_matches_jax(rng):
    seqs, lens, reads, rlens = _scenario(rng, n_contigs=3, L=120,
                                         n_reads=12, repeat=6)
    _, _, got, want = _both(seqs, lens, reads, rlens, fanout=8)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))


def test_jax_cpu_sort_keeps_tie_order_at_index_shapes(rng):
    """What the tie case rests on: the JAX package's index sort
    (`lax.sort` without is_stable) keeps the input order of equal keys on
    its CPU backend at an index row of this size with many ties."""
    n = 60_000
    keys = rng.integers(0, 50, (2, n)).astype(np.uint32)
    ids = np.arange(n, dtype=np.int32)
    out = jax.lax.sort((jnp.asarray(keys[0]), jnp.asarray(keys[1]),
                        jnp.asarray(ids)), dimension=0, num_keys=2)
    np.testing.assert_array_equal(np.asarray(out[2]),
                                  ids[np.lexsort((ids, keys[1], keys[0]))])
