"""K-mer extraction, packing and canonicalisation (counterpart of
gappadder_tpu/ops/kmers.py).

Packing: a k-mer is ceil(k/16) limbs of 16 bases each, big-endian
within and across limbs (base 0 in the top bits of limb 0, unused tail
bits zero), so lexicographic order of limb tuples is the order of the
base strings. The JAX package keeps limbs in uint32; torch's uint32
support is partial, so here every limb is an int64 holding the same
32-bit value. Every complement and left shift is masked back to 32
bits (`& MASK32`): in int64, `~w` is negative and `w << 16` carries
past bit 31. Invalid slots are all-ones limbs (FULL), which sort last.

A gap's table of distinct canonical k-mers (block 3 of the step, and so
the Assembly batch) is built by `merge_chunk` / `merge_chunk_nocnt`
chunk by chunk of reads: concatenate, sort, keep the first of every
run, compact the survivors to the front with a cumsum-rank scatter and
cut back to the table width M. When more than M distinct k-mers exist,
the lexicographically largest fall off the end, the saturation the
caller detects through n == M. `filter_min_count` then applies the
count filter.
"""

from __future__ import annotations

import torch

from . import psort

FULL = 0xFFFFFFFF
MASK32 = 0xFFFFFFFF


def num_limbs(k: int) -> int:
    return (k + 15) // 16


def extract_kmers(seq, length, k: int):
    """Rolling k-mer extraction.

    seq: int8/int32 [..., L] codes (0..3 valid, anything else invalid);
    length: [...] valid lengths. Returns (limbs int64 [..., P, nl],
    valid bool [..., P]) with P = L - k + 1.
    """
    L = seq.shape[-1]
    P = L - k + 1
    assert P >= 1, "sequence shorter than k"
    nl = num_limbs(k)
    # the JAX code casts int8 codes to uint32; bad codes only ever land
    # in slots that are overwritten with FULL below
    seq64 = seq.to(torch.int64) & MASK32
    isbad = (seq >= 4) | (seq < 0)

    limbs = []
    for l in range(nl):
        acc = torch.zeros(seq.shape[:-1] + (P,), dtype=torch.int64,
                          device=seq.device)
        for j in range(16):
            pos = 16 * l + j
            if pos >= k:
                break
            acc = acc | ((seq64[..., pos:pos + P] << (30 - 2 * j)) & MASK32)
        limbs.append(acc)
    limbs = torch.stack(limbs, dim=-1)

    badc = torch.cumsum(isbad.to(torch.int32), dim=-1)
    bad0 = torch.cat([torch.zeros(seq.shape[:-1] + (1,), dtype=badc.dtype,
                                  device=seq.device), badc], dim=-1)
    win_bad = (bad0[..., k:k + P] - bad0[..., 0:P]) > 0
    pos_idx = torch.arange(P, device=seq.device)
    inside = pos_idx <= (length[..., None].to(torch.int64) - k)
    valid = inside & ~win_bad
    limbs = torch.where(valid[..., None], limbs, torch.full_like(limbs, FULL))
    return limbs, valid


def _rev2bit(w):
    """Reverse the 16 2-bit groups of each 32-bit word."""
    w = ((w & 0x33333333) << 2) | ((w & 0xCCCCCCCC) >> 2)
    w = ((w & 0x0F0F0F0F) << 4) | ((w & 0xF0F0F0F0) >> 4)
    w = ((w & 0x00FF00FF) << 8) | ((w & 0xFF00FF00) >> 8)
    return ((w << 16) & MASK32) | (w >> 16)


def revcomp_kmers(limbs, k: int):
    """Reverse-complement packed k-mers (same limb layout): bitwise
    NOT, 2-bit group reversal, then a cross-limb realignment shift."""
    nl = num_limbs(k)
    rev = [_rev2bit(limbs[..., nl - 1 - l] ^ MASK32) for l in range(nl)]
    sh = 2 * (16 * nl - k)
    if sh:
        out = []
        for l in range(nl):
            v = (rev[l] << sh) & MASK32
            if l + 1 < nl:
                v = v | (rev[l + 1] >> (32 - sh))
            out.append(v)
    else:
        out = rev
    used = k - 16 * (nl - 1)
    tail_mask = ((1 << (2 * used)) - 1) << (32 - 2 * used)
    out[nl - 1] = out[nl - 1] & tail_mask
    res = torch.stack(out, dim=-1)
    invalid = torch.all(limbs == FULL, dim=-1, keepdim=True)
    return torch.where(invalid, torch.full_like(res, FULL), res)


def canonicalize(limbs, k: int):
    """Per-k-mer min(kmer, revcomp) — KMC's canonical counting."""
    rc = revcomp_kmers(limbs, k)
    nl = limbs.shape[-1]
    lt = torch.zeros(limbs.shape[:-1], dtype=torch.bool, device=limbs.device)
    gt = torch.zeros_like(lt)
    for l in range(nl):
        a, b = limbs[..., l], rc[..., l]
        lt = lt | (~gt & (a < b))
        gt = gt | (~lt & (a > b))
    take_fwd = lt | ~gt
    return torch.where(take_fwd[..., None], limbs, rc)


def sort_kmers(limbs, extra=None):
    """Sort [..., P, nl] k-mers lexicographically along P; `extra` is an
    optional list of [..., P] tensors carried along. Returns
    (sorted_limbs, sorted_extras)."""
    nl = limbs.shape[-1]
    ops = [limbs[..., l] for l in range(nl)]
    extras = list(extra) if extra is not None else []
    res = psort.bitonic_sort(
        tuple(ops + [e.to(torch.int64) for e in extras]), num_keys=nl)
    return (torch.stack(res[:nl], dim=-1),
            [r.to(e.dtype) for r, e in zip(res[nl:], extras)])


def unique_mask(sorted_limbs):
    """True at the first slot of each distinct k-mer (valid or not)."""
    same = torch.all(sorted_limbs == torch.roll(sorted_limbs, 1, dims=-2),
                     dim=-1)
    first = ~same
    first[..., 0] = True
    return first


def compact(s, keep, M: int, fill: int):
    """Move the `keep` rows of s [G, P, ...] to the front in order
    (a cumsum-rank scatter) and cut to M rows; the rest is `fill`."""
    G, P = keep.shape
    rank = torch.cumsum(keep.to(torch.int64), dim=-1) - 1
    tgt = torch.where(keep, rank, torch.full_like(rank, P))
    out = torch.full((G, P + 1) + tuple(s.shape[2:]), fill, dtype=s.dtype,
                     device=s.device)
    b = torch.arange(G, device=s.device)[:, None].expand(G, P)
    # dropped rows all land in the dump column P, which is cut off
    out[b, tgt] = s
    return out[:, :min(M, P)]


def _next_first(firstv):
    """For each slot i, the index of the next run start after i (or P)."""
    P = firstv.shape[-1]
    idx = torch.arange(P, device=firstv.device)
    v = torch.where(firstv, idx, torch.full_like(idx, P))
    sufmin = torch.flip(torch.cummin(torch.flip(v, dims=(-1,)), dim=-1)
                        .values, dims=(-1,))
    return torch.cat([sufmin[..., 1:],
                      torch.full_like(sufmin[..., :1], P)], dim=-1)


def count_distinct(seq, length, k: int):
    """Canonical k-mer counting over a batch of sequence sets.

    Returns (kmers int64 [..., P, nl] sorted distinct canonical k-mers
    compacted to the front with FULL padding, counts int32 [..., P],
    n_distinct int32 [...])."""
    limbs, valid = extract_kmers(seq, length, k)
    limbs = canonicalize(limbs, k)
    limbs = torch.where(valid[..., None], limbs, torch.full_like(limbs, FULL))
    s, _ = sort_kmers(limbs)
    firstv = unique_mask(s) & ~torch.all(s == FULL, dim=-1)
    sval = ~torch.all(s == FULL, dim=-1)
    P = s.shape[-2]
    idx = torch.arange(P, device=s.device).expand(firstv.shape)
    csum = torch.cumsum(sval.to(torch.int64), dim=-1)
    c0 = torch.cat([torch.zeros_like(csum[..., :1]), csum], dim=-1)
    nxt = _next_first(firstv)
    counts = (torch.gather(c0, -1, nxt)
              - torch.gather(c0, -1, torch.where(firstv, idx,
                                                 torch.zeros_like(idx))))
    counts = torch.where(firstv, counts, torch.zeros_like(counts))
    n_distinct = firstv.sum(-1)
    order = torch.sort((~firstv).to(torch.int8), dim=-1, stable=True).indices
    kmers = torch.gather(s, -2, order[..., None].expand(s.shape))
    counts = torch.gather(counts, -1, order)
    inb = torch.arange(P, device=s.device) < n_distinct[..., None]
    kmers = torch.where(inb[..., None], kmers, torch.full_like(kmers, FULL))
    return kmers, counts.to(torch.int32), n_distinct.to(torch.int32)


def _chunk_limbs(chunk, clen, k: int):
    """The canonical k-mers of a read chunk [G, Rc, L], FULL where
    invalid, flattened to [G, Rc * P, nl], with their validity."""
    limbs, valid = extract_kmers(chunk, clen, k)
    limbs = canonicalize(limbs, k)
    limbs = torch.where(valid[..., None], limbs, torch.full_like(limbs, FULL))
    G = limbs.shape[0]
    return limbs.reshape(G, -1, limbs.shape[-1]), valid.reshape(G, -1)


def merge_chunk(chunk, clen, acc, acc_cnt, k: int):
    """Merge the k-mers of a read chunk (codes [G, Rc, L], lengths
    [G, Rc]) into the distinct table acc [G, M, nl] with multiplicities
    acc_cnt int32 [G, M]. Returns the new (acc, acc_cnt)."""
    flat, valid = _chunk_limbs(chunk, clen, k)
    G, M, nl = acc.shape
    both = torch.cat([acc, flat], dim=1)
    cnts = torch.cat([acc_cnt, valid.to(torch.int32)], dim=1)
    res = psort.bitonic_sort(tuple(both[..., l] for l in range(nl))
                             + (cnts.to(torch.int64),), num_keys=nl)
    s = torch.stack(res[:nl], dim=-1)
    scnt = res[nl]
    first = unique_mask(s)
    keep = first & ~torch.all(s == FULL, dim=-1)
    # segment sums of the counts of equal keys via prefix sums
    csum = torch.cumsum(scnt.to(torch.int64), dim=-1)
    P = s.shape[1]
    idx = torch.arange(P, device=s.device).expand(G, P)
    nxt = _next_first(first)
    c0 = torch.cat([torch.zeros_like(csum[:, :1]), csum], dim=-1)
    seg = (torch.gather(c0, -1, nxt)
           - torch.gather(c0, -1, torch.where(first, idx,
                                              torch.zeros_like(idx))))
    seg = torch.where(keep, seg, torch.zeros_like(seg)).to(torch.int32)
    return compact(s, keep, M, FULL), compact(seg, keep, M, 0)


def merge_chunk_nocnt(chunk, clen, acc, k: int):
    """`merge_chunk` without multiplicities (no count operand, no
    segment sums): the same distinct set."""
    flat, _ = _chunk_limbs(chunk, clen, k)
    G, M, nl = acc.shape
    both = torch.cat([acc, flat], dim=1)
    res = psort.bitonic_sort(tuple(both[..., l] for l in range(nl)),
                             num_keys=nl)
    s = torch.stack(res, dim=-1)
    keep = unique_mask(s) & ~torch.all(s == FULL, dim=-1)
    return compact(s, keep, M, FULL)


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
    acc, ex = sort_kmers(acc, [cnt])
    cnt = ex[0]
    return acc, cnt, ~torch.all(acc == FULL, dim=-1)
