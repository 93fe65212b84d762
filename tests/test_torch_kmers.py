"""Port parity: k-mer packing/canonicalisation/counting and the
distinct-k-mer merge of the count path, JAX vs gappadder_tpu_torch on
the same numpy inputs. Exact equality: every output is an integer."""

import numpy as np
import pytest
import jax.numpy as jnp
import torch

from gappadder_tpu import dna as jdna
from gappadder_tpu.ops import kmers as jk
from gappadder_tpu.pipeline import assemble as jasm
from gappadder_tpu_torch import dna as tdna
from gappadder_tpu_torch.ops import kmers as tk

KS = [17, 31, 32, 33, 50, 64]


def _eq(a, b):
    a = np.asarray(a)
    b = b.numpy()
    assert a.shape == b.shape
    np.testing.assert_array_equal(a.astype(np.int64), b.astype(np.int64))


def _reads(seed, G=2, R=5, L=90):
    """Codes 0..4 (N included) with ragged lengths."""
    rng = np.random.default_rng(seed)
    seq = rng.integers(0, 4, (G, R, L)).astype(np.int8)
    seq[rng.random(seq.shape) < 0.02] = jdna.N
    ln = rng.integers(0, L + 1, (G, R)).astype(np.int32)
    return seq, ln


@pytest.mark.parametrize("k", KS)
def test_extract_revcomp_canonical(k):
    seq, ln = _reads(k)
    a, va = jk.extract_kmers(jnp.asarray(seq), jnp.asarray(ln), k)
    b, vb = tk.extract_kmers(torch.from_numpy(seq), torch.from_numpy(ln), k)
    _eq(a, b)
    _eq(va, vb)
    _eq(jk.revcomp_kmers(a, k), tk.revcomp_kmers(b, k))
    _eq(jk.canonicalize(a, k), tk.canonicalize(b, k))
    sa, _ = jk.sort_kmers(jk.canonicalize(a, k).reshape(2, -1, a.shape[-1]))
    sb, _ = tk.sort_kmers(tk.canonicalize(b, k).reshape(2, -1, b.shape[-1]))
    _eq(sa, sb)
    _eq(jk.unique_mask(sa), tk.unique_mask(sb))


@pytest.mark.parametrize("k", KS)
def test_count_distinct(k):
    seq, ln = _reads(100 + k)
    a = jk.count_distinct(jnp.asarray(seq), jnp.asarray(ln), k)
    b = tk.count_distinct(torch.from_numpy(seq), torch.from_numpy(ln), k)
    for x, y in zip(a, b):
        _eq(x, y)


def test_revcomp_codes():
    rng = np.random.default_rng(3)
    codes = rng.integers(0, 6, (4, 7, 33)).astype(np.int8)
    lens = rng.integers(0, 34, (4, 7)).astype(np.int32)
    _eq(jdna.revcomp_jnp(jnp.asarray(codes)),
        tdna.revcomp_t(torch.from_numpy(codes)))
    _eq(jdna.revcomp_jnp(jnp.asarray(codes), jnp.asarray(lens)),
        tdna.revcomp_t(torch.from_numpy(codes), torch.from_numpy(lens)))
    s = "ACGTNNACGGTA"
    assert tdna.decode(tdna.revcomp(tdna.encode(s))) == \
        jdna.decode(jdna.revcomp(jdna.encode(s)))


@pytest.mark.parametrize("k,M", [(17, 64), (31, 2048), (50, 32)])
def test_merge_chunks(k, M):
    """Two chunk merges into a distinct table of width M (M=32 and 64
    saturate: the largest k-mers fall off), with and without counts."""
    seq, ln = _reads(k + M, G=2, R=6, L=80)
    nl = jk.num_limbs(k)
    ja = jnp.full((2, M, nl), jasm.FULL, jnp.uint32)
    jc = jnp.zeros((2, M), jnp.int32)
    ta = torch.full((2, M, nl), tk.FULL, dtype=torch.int64)
    tc = torch.zeros(2, M, dtype=torch.int32)
    jn, tn = ja, ta
    for lo in (0, 3):
        js, jl = jnp.asarray(seq[:, lo:lo + 3]), jnp.asarray(ln[:, lo:lo + 3])
        ts, tl = torch.from_numpy(seq[:, lo:lo + 3]), \
            torch.from_numpy(ln[:, lo:lo + 3])
        ja, jc = jasm._merge_chunk(js, jl, ja, jc, k)
        ta, tc = tk.merge_chunk(ts, tl, ta, tc, k)
        jn = jasm._merge_chunk_nocnt(js, jl, jn, k)
        tn = tk.merge_chunk_nocnt(ts, tl, tn, k)
    _eq(ja, ta)
    _eq(jc, tc)
    _eq(jn, tn)


@pytest.mark.parametrize("min_count", [0, -1, 3])
def test_filter_min_count(min_count):
    rng = np.random.default_rng(11)
    G, M = 3, 40
    acc = rng.integers(0, 1 << 32, (G, M, 2), dtype=np.uint64)
    acc[:, 30:] = jasm.FULL
    cnt = rng.integers(1, 9, (G, M)).astype(np.int32)
    cnt[0, :10] = 1                       # a high-coverage row with errors
    cnt[0, 10:30] = 12
    cnt[:, 30:] = 0
    ja, jc, jd = jasm.filter_min_count(jnp.asarray(acc.astype(np.uint32)),
                                       jnp.asarray(cnt), min_count)
    ta, tc, td = tk.filter_min_count(torch.from_numpy(acc.astype(np.int64)),
                                     torch.from_numpy(cnt), min_count)
    _eq(ja, ta)
    _eq(jc, tc)
    _eq(jd, td)
