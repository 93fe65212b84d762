"""The distinct-k-mer count path of the assembly stage (counterpart of
gappadder_tpu/pipeline/assemble.py: `_merge_chunk(_impl)`,
`_merge_chunk_nocnt(_impl)` and `filter_min_count`).

Each gap's table of distinct canonical k-mers is merged chunk by chunk
with the k-mers of the next reads: concatenate, sort, keep the first of
every run, compact the survivors to the front with a cumsum-rank
scatter and cut back to the table width M. When more than M distinct
k-mers exist, the lexicographically largest fall off the end — the
saturation behaviour the caller detects through n == M.
"""

from __future__ import annotations

import torch

from ..ops import kmers, psort

FULL = 0xFFFFFFFF


def filter_min_count(acc, cnt, min_count: int):
    """Apply the min_kmer_count policy to a merged table: 0 keeps
    everything, -1 is the adaptive error filter, >1 a fixed cutoff.
    Returns (acc, cnt, distinct) with survivors re-compacted.

    The adaptive filter takes float32 sums as the JAX code does. Both
    sums are exact while they stay below 2^24; above that, torch and
    XLA add in different orders, and the `>= 4` test can flip only when
    the mean lies within float32 rounding of 4."""
    distinct = ~torch.all(acc == FULL, dim=-1)
    if min_count == -1:
        counts = torch.where(distinct, cnt, torch.zeros_like(cnt))
        cf = counts.to(torch.float32)
        inst = torch.sum(cf, dim=-1)
        inst2 = torch.sum(cf * cf, dim=-1)
        mean_inst = inst2 / torch.clamp(inst, min=1.0)
        drop = (mean_inst >= 4)[:, None] & (cnt < 2)
        distinct = distinct & ~drop
    elif min_count > 1:
        distinct = distinct & (cnt >= min_count)
    else:
        return acc, cnt, distinct
    acc = torch.where(distinct[..., None], acc, torch.full_like(acc, FULL))
    cnt = torch.where(distinct, cnt, torch.zeros_like(cnt))
    acc, ex = kmers.sort_kmers(acc, [cnt])
    cnt = ex[0]
    return acc, cnt, ~torch.all(acc == FULL, dim=-1)


def _merge_chunk_impl(acc, acc_cnt, limbs_new, cnt_new):
    G, M, nl = acc.shape
    both = torch.cat([acc, limbs_new], dim=1)
    cnts = torch.cat([acc_cnt, cnt_new], dim=1)
    res = psort.bitonic_sort(tuple(both[..., l] for l in range(nl))
                             + (cnts,), num_keys=nl)
    s = torch.stack(res[:nl], dim=-1)
    scnt = res[nl]
    first = kmers.unique_mask(s)
    keep = first & ~torch.all(s == FULL, dim=-1)
    # segment sums of the counts of equal keys via prefix sums
    csum = torch.cumsum(scnt.to(torch.int64), dim=-1)
    P = s.shape[1]
    idx = torch.arange(P, device=s.device).expand(G, P)
    nxt = kmers._next_first(first)
    c0 = torch.cat([torch.zeros_like(csum[:, :1]), csum], dim=-1)
    seg = (torch.gather(c0, -1, nxt)
           - torch.gather(c0, -1, torch.where(first, idx,
                                              torch.zeros_like(idx))))
    seg = torch.where(keep, seg, torch.zeros_like(seg)).to(torch.int32)
    return (kmers.compact(s, keep, M, FULL),
            kmers.compact(seg, keep, M, 0))


def _chunk_limbs(chunk, clen, k: int):
    limbs, valid = kmers.extract_kmers(chunk, clen, k)    # [G, Rc, P, nl]
    limbs = kmers.canonicalize(limbs, k)
    limbs = torch.where(valid[..., None], limbs, torch.full_like(limbs, FULL))
    G = limbs.shape[0]
    return limbs.reshape(G, -1, limbs.shape[-1]), valid.reshape(G, -1)


def _merge_chunk(chunk, clen, acc, acc_cnt, k: int):
    flat, valid = _chunk_limbs(chunk, clen, k)
    return _merge_chunk_impl(acc, acc_cnt, flat, valid.to(torch.int32))


def _merge_chunk_nocnt_impl(acc, limbs_new):
    """Distinct-set merge without multiplicities (no count operand, no
    segment sums)."""
    G, M, nl = acc.shape
    both = torch.cat([acc, limbs_new], dim=1)
    res = psort.bitonic_sort(tuple(both[..., l] for l in range(nl)),
                             num_keys=nl)
    s = torch.stack(res, dim=-1)
    keep = kmers.unique_mask(s) & ~torch.all(s == FULL, dim=-1)
    return kmers.compact(s, keep, M, FULL)


def _merge_chunk_nocnt(chunk, clen, acc, k: int):
    flat, _ = _chunk_limbs(chunk, clen, k)
    return _merge_chunk_nocnt_impl(acc, flat)
