"""Scaffolding from contig connection tables, TERefiner -S (counterpart
of gappadder_tpu/tools/scaffold.py).

Reference (TERefiner's scaffolding.cpp:25-340), two
passes over the -L connection table (rows: id1 name1 len1 dir1 id2
name2 len2 dir2 n_pairs min_dist max_dist mean_dist):

1. mergeContigs (:34-133): rows with mean_dist > 0 pass through
   unchanged. For the rest, take the ORIENTED sequences (dir '+' =
   forward, '-' = reverse complement), window the last/first
   min_gap = min(-min_dist, shorter contig length) bases, and local-
   align the windows; the pair is a real overlap merge when the local
   hit spans > 7 bp, ends exactly at the left window's end and starts
   exactly at the right window's start. Negative-distance rows WITHOUT
   such an anchored overlap are DISCARDED (written to _discarded.txt
   in the reference; dropped here).

2. constructConnectedContigs (:174-340): group rows by the LEFT
   (name, dir) node; ave_pe = integer mean of that node's mate
   supports; every mate with support >= ave_pe emits ONE PAIRWISE
   record (the reference explicitly "only output[s] the two-connected
   situations"): header "lname$ori1$rname$ori2$dist" (dist = -overlap
   for merged rows, else int(mean_dist)), sequence = oriented left +
   N-run of int(mean_dist) + oriented right, or the overlap-trimmed
   concatenation.

The window alignments run through the SW kernel on `device` (the card
unless the caller asks for "cpu"), one lone pair a call; the
traceback is the host's.

``chain=True`` additionally links qualifying pairs into multi-contig
scaffold chains — an extension beyond the reference's pairwise output.
"""

from __future__ import annotations

import numpy as np

from .. import dna, entry_device
from ..ops import swutil
from ..ops.sw_host import SWParams, traceback

MIN_OVERLAP = 7  # scaffolding.cpp:13 (const int OVERLAP=7)

# stdaln-ish scoring for the window overlap check
_P = SWParams(1, -3, 5, 2)


def _local_span(a: np.ndarray, b: np.ndarray, device):
    """Best local alignment of a vs b -> 1-based (as, ae, bs, be) or
    None (the optAlign call of scaffolding.cpp:103-121)."""
    if len(a) == 0 or len(b) == 0:
        return None
    s, qe, te = swutil.sw_small([a], [b], _P, "local", device=device)
    if int(s[0]) <= 0:
        return None
    qs, ts, _ = traceback(a, b, _P, "local", int(qe[0]), int(te[0]))
    return qs + 1, int(qe[0]), ts + 1, int(te[0])


def _oriented(contigs, name_idx, name, ori):
    seq = contigs[name_idx[name]]
    return seq if ori == "+" else dna.revcomp(seq)


def merge_connections(contigs, names, links, device="cuda"):
    """Pass 1: annotate rows with (bmerged, overlap); drop discards.

    Returns rows (id1, n1, l1, d1, id2, n2, l2, d2, n_pairs, dmin,
    dmax, dmean, bmerged, overlap).
    """
    device = entry_device(device, "merge_connections")
    name_idx = {n: i for i, n in enumerate(names)}
    out = []
    for (a, n1, l1, d1, b, n2, l2, d2, np_, dmin, dmax, dmean) in links:
        if dmean > 0:
            out.append((a, n1, l1, d1, b, n2, l2, d2, np_, dmin, dmax,
                        dmean, False, 0))
            continue
        lc = _oriented(contigs, name_idx, n1, d1)
        rc = _oriented(contigs, name_idx, n2, d2)
        min_gap = int(-1 * dmin)
        min_gap = min(min_gap, min(l1, l2))
        if min_gap <= 0:
            continue
        lsub = lc[l1 - min_gap:]
        rsub = rc[:min_gap]
        span = _local_span(lsub, rsub, device)
        if span is None:
            continue
        ls, le, rs, re = span
        overlap = le - ls + 1
        if overlap > MIN_OVERLAP and le == len(lsub) and rs == 1:
            out.append((a, n1, l1, d1, b, n2, l2, d2, np_, dmin, dmax,
                        dmean, True, overlap))
        # else: discarded (negative distance, no anchored overlap)
    return out


def build_scaffolds(contigs: list[np.ndarray], names: list[str],
                    links, chain: bool = False, device="cuda"):
    """links: raw -L rows from cnt_contig_linkage. Returns (records,
    used) — records are (name, codes) pairwise joins per the
    reference; used is the set of contig indices in any record."""
    device = entry_device(device, "build_scaffolds")
    name_idx = {n: i for i, n in enumerate(names)}
    rows = merge_connections(contigs, names, links, device)

    # group by LEFT (name, dir) node
    groups: dict[tuple[str, str], list] = {}
    for r in rows:
        groups.setdefault((r[1], r[3]), []).append(r)

    records = []
    used = set()
    joins = []          # qualifying (lname, d1, rname, d2, dist, ov)
    for (lname, d1), mates in groups.items():
        ave_pe = sum(m[8] for m in mates) // len(mates)  # int div, ref
        for m in mates:
            if m[8] < ave_pe:
                continue
            (_, n1, l1, _, _, n2, l2, d2, np_, dmin, dmax, dmean,
             bmerged, overlap) = m
            lseq = _oriented(contigs, name_idx, n1, d1)
            rseq = _oriented(contigs, name_idx, n2, d2)
            if overlap == 0:
                dist = int(dmean)
                seq = np.concatenate(
                    [lseq, np.full(max(dist, 0), dna.N, np.int8), rseq])
            else:
                dist = -overlap
                seq = np.concatenate([lseq, rseq[overlap:]])
            records.append((f"{n1}${d1}${n2}${d2}${dist}", seq))
            used.add(name_idx[n1])
            used.add(name_idx[n2])
            joins.append((n1, d1, n2, d2, dist, overlap))

    if chain and joins:
        records += _chain_records(contigs, name_idx, joins)
    return records, used


def _chain_records(contigs, name_idx, joins):
    """Extension: link pairwise joins into maximal chains (each contig
    used once per side, first-come order)."""
    nxt, prev, meta = {}, {}, {}
    for (n1, d1, n2, d2, dist, ov) in joins:
        if (n1, d1) in nxt or (n2, d2) in prev:
            continue
        nxt[(n1, d1)] = (n2, d2)
        prev[(n2, d2)] = (n1, d1)
        meta[((n1, d1), (n2, d2))] = (dist, ov)
    heads = [k for k in nxt if k not in prev]
    out = []
    cnt = 0
    for h in heads:
        path = [h]
        seen = {h}
        while path[-1] in nxt and nxt[path[-1]] not in seen:
            path.append(nxt[path[-1]])
            seen.add(path[-1])
        if len(path) < 3:
            continue            # pairwise already emitted
        seq = _oriented(contigs, name_idx, *path[0])
        for a, b in zip(path, path[1:]):
            dist, ov = meta[(a, b)]
            rseq = _oriented(contigs, name_idx, *b)
            if ov:
                seq = np.concatenate([seq, rseq[ov:]])
            else:
                seq = np.concatenate(
                    [seq, np.full(max(dist, 0), dna.N, np.int8), rseq])
        out.append((f"scaffold_chain_{cnt}_" +
                    "_".join(n for n, _ in path), seq))
        cnt += 1
    return out
