"""The fused gap-batch step's outputs worked out again in plain numpy,
Python and PyTorch, and the numbers by which a step's outputs differ
from them:

  read tables   blocks 1-2: each gap's reads (`recruit.classify` against
                the gap windows, without Collect's low-mapq pass, joined
                to the read table by name and side, deduplicated), rows
                ascending, at most reads_per_gap; hq where a recruiting
                record has mapq hq_mapq; the clip / disc / unmap hit
                counts
  unitigs       block 3: each (gap, (k, sub_k)) lane's unitigs of the
                gap's reads (`dbg.unitigs`), sequence for sequence in
                slot order
  scores        block 4: local SW of each flank, both strands, against
                each of the step's own contig slots (`sw.local_sw`),
                score, query end and target end; 0 where the flank or
                the slot is empty

Nothing here imports the program.
"""

from __future__ import annotations

import numpy as np
import torch

from . import dbg, recruit, sw

COMP = np.array([3, 2, 1, 0, 4], np.int8)


def read_tables(args, dims: dict, params: dict):
    """(rowtab int32 [G, R], hqtab bool [G, R], n_reads int32 [G],
    counts (clip, disc, unmap)) of a batch's 28 input arrays."""
    rec = {k: np.asarray(args[i]).astype(np.int64) for i, k in enumerate(
        ("tid", "pos", "flag", "mapq", "mtid", "mpos", "tlen", "lclip",
         "rclip"))}
    # a pair is its 64-bit name; a recruit's row is the read table's row
    # of (name, side)
    name = (np.asarray(args[9]).astype(np.uint64) << np.uint64(32)) | \
        np.asarray(args[10]).astype(np.uint64)
    names, pair = np.unique(name, return_inverse=True)
    rec["pair"] = pair.reshape(-1)
    rec["first"] = (rec["flag"] & 0x40) != 0
    table = {(int(h) << 32 | int(lo), int(sd)): int(r) for h, lo, r, sd in
             zip(args[18], args[19], args[20], args[21])}
    gs, ge = np.asarray(args[16], np.int64), np.asarray(args[17], np.int64)
    G, R = dims["n_gaps"], dims["reads_per_gap"]
    (g, s, p, h), counts = recruit.classify(
        rec, {"scaffold": np.zeros(G, np.int64), "start": gs, "end": ge},
        **params, low_mapq_pass=False)
    g, s, p, h = recruit.union(g, s, p, h)
    r = np.array([table.get((int(names[x]), int(y)), -1)
                  for x, y in zip(p, s)], np.int64)
    ok = r >= 0
    g, r, h = g[ok], r[ok], h[ok]
    order = np.lexsort((r, g))
    g, r, h = g[order], r[order], h[order]
    rowtab = np.full((G, R), -1, np.int32)
    hqtab = np.zeros((G, R), bool)
    n_reads = np.zeros(G, np.int32)
    for gap in range(G):
        m = np.flatnonzero(g == gap)[:R]
        rowtab[gap, :len(m)] = r[m]
        hqtab[gap, :len(m)] = h[m]
        n_reads[gap] = len(m)
    return rowtab, hqtab, n_reads, counts


def lane_unitigs(args, rowtab, dims: dict, stats=None) -> list:
    """[G][S] lists of each lane's unitigs from the gap's reads, in slot
    order; `stats` as `dbg.unitigs` keeps it, summed over the lanes."""
    reads_tbl, reads_len = np.asarray(args[22]), np.asarray(args[23])
    out = []
    for gap in range(rowtab.shape[0]):
        rows = rowtab[gap][rowtab[gap] >= 0]
        reads = [dbg.decode(reads_tbl[x][:reads_len[x]]) for x in rows]
        per_k = {}
        lane = []
        for k, sub_k in dims["kset"]:
            if k not in per_k:
                per_k[k] = dbg.kmers(reads, k)
            lane.append(dbg.unitigs(per_k[k], sub_k, dims["min_contig_len"],
                                    dims["max_unitigs"],
                                    dims["max_contig_len"], stats))
        out.append(lane)
    return out


def program_unitigs(useq, ulen, ucnt, dims: dict) -> list:
    """[G][S] lists of a step's unitigs in slot order: the first ucnt
    slots of each lane."""
    mu = dims["max_unitigs"]
    return [[[dbg.decode(useq[g, s * mu + i, :ulen[g, s * mu + i]])
              for i in range(int(ucnt[g, s]))]
             for s in range(len(dims["kset"]))]
            for g in range(useq.shape[0])]


def flank_scores(args, useq, ulen, device, band=None):
    """Local SW of each gap's 4 flank queries (left, left reversed,
    right, right reversed) against each contig slot: (score, qend, tend)
    int32 [G, 4, C], 0 where the query or the slot is empty."""
    fl, fr = np.asarray(args[24]), np.asarray(args[25])
    fll, frl = np.asarray(args[26]), np.asarray(args[27])
    G, C, _Lc = useq.shape
    FL = fl.shape[1]
    q4 = np.zeros((G, 4, FL), np.int8)
    ql4 = np.zeros((G, 4), np.int32)
    for g in range(G):
        for i, (f, n) in enumerate(((fl[g], fll[g]), (fr[g], frl[g]))):
            q4[g, 2 * i, :n] = f[:n]
            q4[g, 2 * i + 1, :n] = COMP[np.clip(f[:n], 0, 4)][::-1]
            ql4[g, 2 * i:2 * i + 2] = n
    live = (ql4[:, :, None] > 0) & (ulen[:, None, :] > 0)
    gi, qi, ci = np.nonzero(live)
    res = [np.zeros((G, 4, C), np.int32) for _ in range(3)]
    if len(gi):
        Lt = int(ulen.max())
        args_t = [torch.from_numpy(np.ascontiguousarray(x)).to(device)
                  for x in (q4[gi, qi], ql4[gi, qi], useq[gi, ci, :Lt],
                            ulen[gi, ci])]
        for out, r in zip(res, sw.local_sw(*args_t, band=band)):
            out[gi, qi, ci] = r.cpu().numpy()
    return res


def judge(args, out, dims: dict, params: dict, device, ref=None) -> dict:
    """The numbers by which a step's outputs (`out`: its 12 outputs as
    numpy) differ from the reference on the batch (`args`). `ref` may
    hold (read tables, lane unitigs) already worked out."""
    counts, _hist, _recv, n_reads, rowtab, hqtab, useq, ulen, ucnt, \
        score, qend, tend = out
    rt, hq, nr, c3 = ref[0] if ref else read_tables(args, dims, params)
    units = ref[1] if ref else lane_unitigs(args, rt, dims)
    tables = int(sum(not (np.array_equal(rowtab[g], rt[g])
                          and np.array_equal(hqtab[g], hq[g])
                          and n_reads[g] == nr[g])
                     for g in range(len(nr))))
    tables += int(np.abs(np.asarray(counts[:3], np.int64)
                         - np.asarray(c3)).sum())
    got = program_unitigs(useq, ulen, ucnt, dims)
    lanes = sum(got[g][s] != units[g][s] for g in range(len(got))
                for s in range(len(dims["kset"])))
    want = flank_scores(args, useq, ulen, device)
    scores = sum(int((a != b).sum()) for a, b in zip((score, qend, tend),
                                                     want))
    return {"read_tables": tables, "unitigs": lanes, "flank_scores": scores}


def reference_outputs(args, dims: dict, params: dict, device, band=None):
    """The step's 12 outputs as the reference makes them (hist and
    capacity indicators left at 0), with block 4's SW banded to `band`:
    what the control puts in the program's place. Returns (outputs,
    (read tables, lane unitigs))."""
    rt, hq, nr, c3 = read_tables(args, dims, params)
    units = lane_unitigs(args, rt, dims)
    G, mu = len(nr), dims["max_unitigs"]
    S, Lc = len(dims["kset"]), dims["max_contig_len"]
    useq = np.full((G, S * mu, Lc), 4, np.int8)
    ulen = np.zeros((G, S * mu), np.int32)
    ucnt = np.zeros((G, S), np.int32)
    lut = np.frombuffer(b"ACGT", np.uint8)
    for g in range(G):
        for s in range(S):
            ucnt[g, s] = len(units[g][s])
            for i, u in enumerate(units[g][s]):
                useq[g, s * mu + i, :len(u)] = np.searchsorted(
                    lut, np.frombuffer(u.encode(), np.uint8))
                ulen[g, s * mu + i] = len(u)
    score, qend, tend = flank_scores(args, useq, ulen, device, band=band)
    counts = np.zeros(8, np.int32)
    counts[:3] = c3
    out = [counts, None, None, nr, rt, hq, useq, ulen, ucnt, score, qend,
           tend]
    return out, ((rt, hq, nr, c3), units)
