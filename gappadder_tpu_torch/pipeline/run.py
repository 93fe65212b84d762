"""The first functions of the Assembly+Pick stage (counterpart of
gappadder_tpu/pipeline/run.py): grouping recruits per gap, the
read-count buckets of the Assembly batches, restacking a contig store
into a pick batch, and the pick of a gap list (`_pick_gaps`).

The two-round loop (`run_assembly_and_pick`, `_assemble_gaps`) needs
the contig merge and comes with it.
"""

from __future__ import annotations

import numpy as np

from .. import dna
from . import assemble, pick


def build_gap_read_arrays(rec, readsets, n_gaps: int):
    """Group recruited reads per gap into ragged lists of row refs."""
    per_gap: list[list[tuple[int, int, int]]] = [[] for _ in range(n_gaps)]
    for g, side, li, row in zip(rec["gap"], rec["side"], rec["lib"],
                                rec["row"]):
        per_gap[int(g)].append((int(li), int(side), int(row)))
    return per_gap


def _tuple_from_list(clist, cnames):
    """(seq 2-D, lens, count, names) from a ragged contig list."""
    n = len(clist)
    Lmax = max((len(c) for c in clist), default=1)
    seq = np.full((max(n, 1), Lmax), dna.N, np.int8)
    lens = np.zeros(max(n, 1), np.int32)
    for i, c in enumerate(clist):
        seq[i, :len(c)] = c
        lens[i] = len(c)
    return seq, lens, n, list(cnames)


def _restack(contig_store, batch):
    C = max(max(contig_store[g][2] for g in batch), 1)
    Lmax = max(contig_store[g][0].shape[1] for g in batch)
    seq = np.full((len(batch), C, Lmax), dna.N, np.int8)
    lens = np.zeros((len(batch), C), np.int32)
    cnt = np.zeros(len(batch), np.int32)
    names = []
    for i, g in enumerate(batch):
        s, l, n, nm = contig_store[g]
        seq[i, :n, :s.shape[1]] = s[:n]
        lens[i, :n] = l[:n]
        cnt[i] = n
        names.append(nm)
    return assemble.GapContigs(seq=seq, length=lens, count=cnt, names=names)


# coarse read-count buckets -> (reads bucket, max-distinct-kmer START);
# few distinct shapes keep the padded batches small. The
# distinct-kmer bound is a STARTING point: real per-gap distinct counts
# sit far below the worst case (coverage piles reads onto the same
# region k-mers), every cap auto-grows on the step's overflow
# indicators, and the DBG's sort/gather volume scales with the PADDED
# cap, not the live k-mers — so starting tight pays on any device.
# Gaps beyond the last bucket get dynamic power-of-two buckets (no
# cap): the reference's Velvet input is unbounded (assemble_gaps.py:96-118).
_BUCKETS = ((1 << 6, 1 << 10), (1 << 9, 1 << 12), (1 << 12, 1 << 13),
            (1 << 15, 1 << 15))


def _bucket_of(n: int):
    """(reads bucket R, distinct-kmer start bound) for an n-read gap."""
    for r, md in _BUCKETS:
        if n <= r:
            return r, md
    R = 1 << max(n - 1, 1).bit_length()
    return R, 2 * R


def _pick_gaps(cfg, gaps, gap_list, contig_store, fills, exts, min_score,
               allow_extension, device="cuda"):
    """Pick the gaps of `gap_list` that have contigs and no fill yet, in
    batches of 64: full closures into `fills[g] = (seq, contig name)`,
    and with `allow_extension` the extension fallback into `exts`. The
    SW passes run on `device` (the card unless the caller asks for
    "cpu")."""
    gap_list = [g for g in gap_list if g in contig_store
                and contig_store[g][2] > 0 and g not in fills]
    # 64-gap pick batches: each batch is up to max_hits local passes
    # and one fit pass on the device; the winners' tracebacks are host
    for lo in range(0, len(gap_list), 64):
        batch = gap_list[lo:lo + 64]
        if not batch:
            continue
        gc = _restack(contig_store, batch)
        fl = gaps["flank_left"][batch]
        fr = gaps["flank_right"][batch]
        hits = pick.align_flanks_to_contigs(
            fl, fr, gc.seq, gc.length, gc.count,
            min_score=min_score, max_hits=cfg.pick_max_hits,
            device=device)
        for i, g in enumerate(batch):
            res = pick.pick_full(hits[i], gc.seq[i], gc.length[i])
            if res is not None:
                c, gap_seq, rc, _ = res
                fills[g] = (gap_seq, gc.names[i][c])
            elif allow_extension and g not in exts:
                res = pick.pick_extension(hits[i], gc.seq[i], gc.length[i])
                if res is not None:
                    lc, rc_, seq, _ = res
                    nm = gc.names[i]
                    lname = nm[lc] if lc >= 0 else ""
                    rname = nm[rc_] if rc_ >= 0 else ""
                    # keep the exact winner names alongside the joined
                    # display string (contig names embed underscores,
                    # so the joined form is not splittable)
                    exts[g] = (seq, f"{lname}_{rname}", (lname, rname))
