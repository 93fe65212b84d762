"""Gap batches for the fused step: the alignment records and reads of one
paired-end library around a batch's gaps, as a mapper leaves them, as
the step's 28 input arrays. Numpy only, no import of the program.

A batch's gaps lie on one scaffold (tid 0), `span` bases apart, so that
no read is in two gaps' windows; a second scaffold (tid 1) holds where
chimeric pairs take their other read from. FR pairs are drawn
uniformly over both at the library's coverage, insert sizes normal.
Each read is placed as `genome_files.place` places it: a read over a
gap edge is soft-clipped on the gap side (unmapped under 20 aligned
bases) and a read inside a gap is unmapped and sits at its mate's
place; a pair inside a gap is flagged 12. Reads carry substitution
errors; mapped reads draw their mapq from the configuration's mix.
Which mate is read 1 is drawn a pair. The read table holds both mates
of every pair (side 0 read 1, side 1 read 2) under a 64-bit name hash.
"""

from __future__ import annotations

import numpy as np

from portbench.traffic.genome_files import COMPLEMENT, place


def gap_windows(gs, ge, dist2: int):
    """Two windows a gap (edge 0 left of it, edge 1 right of it), sorted
    by (tid, start): int32 columns tid, start, end, gap, edge."""
    G = len(gs)
    tid = np.zeros(2 * G, np.int32)
    start = np.concatenate([gs - dist2, ge - 1]).astype(np.int32)
    end = np.concatenate([gs - 1, ge + dist2 - 2]).astype(np.int32)
    gap = np.tile(np.arange(G, dtype=np.int32), 2)
    edge = np.repeat(np.array([0, 1], np.int32), G)
    order = np.lexsort((start, tid))
    return tid[order], start[order], end[order], gap[order], edge[order]


def draw_mapq(rng, n: int, mix: dict):
    """n mapq values: each range "lo-hi" of `mix` (inclusive) takes its
    share, drawn uniformly inside it; the rest is 60."""
    u = rng.random(n)
    mq = np.full(n, 60, np.int32)
    edge = 0.0
    for rng_s, share in mix.items():
        lo, hi = (int(x) for x in rng_s.split("-"))
        sel = (u >= edge) & (u < edge + share)
        mq[sel] = rng.integers(lo, hi + 1, int(sel.sum()))
        edge += share
    return mq


def batch(seed, *, gaps: int, gap_len, read_len: int, flank_len: int,
          insert: int, std: int, coverage: float, errors: float,
          mapq: dict, chimeric: float, foreign_len: int, dist2: int,
          caps: dict, kset):
    """One batch: (dims, args). dims a dict of the step's static sizes
    (the configuration's caps, the same for every batch and seed), args
    the 28 arrays in the step's order. Gap lengths are drawn
    log-uniformly in the inclusive range `gap_len`."""
    rng = np.random.default_rng(seed)
    lo, hi = gap_len
    glens = np.exp(rng.uniform(np.log(lo), np.log(hi), gaps))
    glens = np.clip(np.round(glens).astype(np.int64), lo, hi)
    reach = dist2 + insert + 4 * std
    span = int(hi) + 2 * reach
    L = gaps * span + 2 * flank_len
    truth = rng.integers(0, 4, L + foreign_len).astype(np.int8)
    gs = flank_len + np.arange(gaps, dtype=np.int64) * span + reach
    ge = gs + glens
    rl = read_len

    # FR pairs over both scaffolds; a chimeric pair's second read from
    # the other scaffold
    n = int(round(coverage * (L + foreign_len) / (2 * rl)))
    ins = np.clip(np.round(rng.normal(insert, std, n)), 2 * rl + 2,
                  4 * insert).astype(np.int64)
    on1 = rng.random(n) < foreign_len / (L + foreign_len)
    base, size = np.where(on1, L, 0), np.where(on1, foreign_len, L)
    a1 = base + (rng.random(n) * (size - ins)).astype(np.int64)
    a2 = a1 + ins - rl
    chim = rng.random(n) < chimeric
    other = np.where(on1, 0, L) + (rng.random(n) * np.where(
        on1, L - rl, foreign_len - rl)).astype(np.int64)
    a2 = np.where(chim, other, a2)
    offs = np.arange(rl)
    fwd = truth[a1[:, None] + offs]
    rev = COMPLEMENT[truth[a2[:, None] + (rl - 1 - offs)]]
    for s in (fwd, rev):
        err = rng.random(s.shape) < errors
        shift = rng.integers(1, 4, s.shape).astype(np.int8)
        s[err] = (s[err] + shift[err]) % 4

    def placed(a):
        """(mapped, tid, pos, lclip, rclip): tid 0 through the gaps,
        tid 1 whole."""
        m, pos, lc, rc = place(a, rl, gs, ge)
        f = a >= L
        return (m | f, f.astype(np.int64), np.where(f, a - L, pos),
                np.where(f, 0, lc), np.where(f, 0, rc))
    m1, t1, p1, lc1, rc1 = placed(a1)
    m2, t2, p2, lc2, rc2 = placed(a2)
    tid1 = np.where(m1, t1, np.where(m2, t2, -1))
    tid2 = np.where(m2, t2, np.where(m1, t1, -1))
    lp1 = np.where(m1, p1, np.where(m2, p2, -1))
    lp2 = np.where(m2, p2, np.where(m1, p1, -1))
    tl = np.where(m1 & m2 & (tid1 == tid2), ins, 0)
    # read 1 is the forward read on half the pairs
    first_fwd = rng.random(n) < 0.5
    f1 = 0x1 | 0x20 | np.where(m1, 0, 0x4) | np.where(m2, 0, 0x8) | \
        np.where(first_fwd, 0x40, 0x80)
    f2 = 0x1 | 0x10 | np.where(m2, 0, 0x4) | np.where(m1, 0, 0x8) | \
        np.where(first_fwd, 0x80, 0x40)
    mq1 = np.where(m1, draw_mapq(rng, n, mapq), 0)
    mq2 = np.where(m2, draw_mapq(rng, n, mapq), 0)
    cols = dict(
        tid=np.concatenate([tid1, tid2]), pos=np.concatenate([lp1, lp2]),
        flag=np.concatenate([f1, f2]), mapq=np.concatenate([mq1, mq2]),
        mtid=np.concatenate([tid2, tid1]), mpos=np.concatenate([lp2, lp1]),
        tlen=np.concatenate([tl, -tl]),
        lclip=np.concatenate([np.where(m1, lc1, 0), np.where(m2, lc2, 0)]),
        rclip=np.concatenate([np.where(m1, rc1, 0), np.where(m2, rc2, 0)]))
    pair = np.concatenate([np.arange(n), np.arange(n)])
    # coordinate-sorted, unplaced pairs last
    key = np.where(cols["tid"] < 0, 2 * (L + foreign_len),
                   cols["tid"] * (L + foreign_len) + cols["pos"])
    order = np.argsort(key, kind="stable")
    rec = {k: v[order].astype(np.int32) for k, v in cols.items()}
    pair = pair[order]

    # names: a 64-bit hash a pair; the read table holds read 1 (side 0)
    # in rows [0, n) and read 2 (side 1) in rows [n, 2n)
    name_hi = rng.integers(0, 1 << 32, n, dtype=np.uint64).astype(np.uint32)
    name_lo = rng.permutation(n).astype(np.uint32)
    read1 = np.where(first_fwd[:, None], fwd, rev)
    read2 = np.where(first_fwd[:, None], rev, fwd)
    reads_tbl = np.concatenate([read1, read2]).astype(np.int8)
    reads_len = np.full(2 * n, rl, np.int32)
    tbl_hi = np.concatenate([name_hi, name_hi])
    tbl_lo = np.concatenate([name_lo, name_lo])
    tbl_row = np.arange(2 * n, dtype=np.int32)
    tbl_side = np.repeat(np.array([0, 1], np.int32), n)

    gs32, ge32 = gs.astype(np.int32), ge.astype(np.int32)
    wtid, wstart, wend, wgap, wedge = gap_windows(gs32, ge32, dist2)
    flank_l = truth[gs[:, None] - flank_len + np.arange(flank_len)]
    flank_r = truth[ge[:, None] + np.arange(flank_len)]
    flank_ll = np.full(gaps, flank_len, np.int32)
    flank_rl = np.full(gaps, flank_len, np.int32)
    dims = dict(n_shards=1, n_gaps=gaps, gaps_per_shard=gaps, **caps,
                kset=tuple(tuple(s) for s in kset))
    args = (rec["tid"], rec["pos"], rec["flag"], rec["mapq"], rec["mtid"],
            rec["mpos"], rec["tlen"], rec["lclip"], rec["rclip"],
            name_hi[pair], name_lo[pair],
            wtid, wstart, wend, wgap, wedge, gs32, ge32,
            tbl_hi, tbl_lo, tbl_row, tbl_side,
            reads_tbl, reads_len, flank_l, flank_r, flank_ll, flank_rl)
    return dims, args
