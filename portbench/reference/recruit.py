"""Which reads each gap recruits, worked out in plain numpy from the
alignment records themselves (GAPPadder's collect_reads_for_gaps and
collect_discordant_low_mapq_reads rules, as the configuration states
them):

  windows  two a gap, 0-based: edge 0 [start - dist2, start - 1],
           edge 1 [end - 1, end + dist2 - 2], on the gap's scaffold
  clip     a record in a window, soft-clipped toward the gap (edge 0
           right-clipped, edge 1 left-clipped) and inside the clip zone
           (edge 0 pos >= start - clip_dist - 1, edge 1
           pos <= end + clip_dist - 1): recruits the read itself
  disc     a record in a window, both reads mapped, mapq >= anchor_mapq,
           its mate on another scaffold or |tlen| >= dist2 (short
           inserts also |tlen| <= dist1): recruits the mate
  unmap    a mapped record in a window whose mate is unmapped: recruits
           the mate
  low mapq a mapq-0 record within [mp - 199, mp + 299] of a discordant
           record's mate position mp (same scaffold); where several mate
           positions cover it only the largest wins: recruits the read
           itself, never as high quality

A recruit is (gap, side, row): side 0 the left FASTQ, 1 the right, row
the read pair's FASTQ row; it is high quality when any record that
recruited it has mapq == hq_mapq. Nothing here imports the program.
"""

from __future__ import annotations

import numpy as np

LOW_MAPQ_BEFORE, LOW_MAPQ_AFTER = 199, 299


def gap_windows(scaffold, start, end, dist2: int):
    """(tid, start, end, gap, edge) int64 columns, two rows a gap."""
    G = len(start)
    return (np.concatenate([scaffold, scaffold]).astype(np.int64),
            np.concatenate([start - dist2, end - 1]).astype(np.int64),
            np.concatenate([start - 1, end + dist2 - 2]).astype(np.int64),
            np.tile(np.arange(G), 2), np.repeat([0, 1], G))


def hits(tid, pos, wtid, wstart, wend):
    """Every (record, window) pair with the record's (tid, pos) inside
    the window: two int64 index arrays."""
    key = tid.astype(np.int64) * (1 << 34) + pos
    order = np.argsort(key, kind="stable")
    skey = key[order]
    recs, wins = [], []
    for w in range(len(wtid)):
        lo = np.searchsorted(skey, wtid[w] * (1 << 34) + wstart[w], "left")
        hi = np.searchsorted(skey, wtid[w] * (1 << 34) + wend[w], "right")
        recs.append(order[lo:hi])
        wins.append(np.full(hi - lo, w))
    if not recs:
        z = np.zeros(0, np.int64)
        return z, z
    return np.concatenate(recs), np.concatenate(wins)


def classify(rec, gaps, *, dist1: int, dist2: int, clip_dist: int,
             anchor_mapq: int, hq_mapq: int, short_insert: bool,
             low_mapq_pass: bool = True):
    """The entries one library's records make: (gap, side, row, hq)
    int64 / bool arrays, one a recruiting record and gap (duplicates
    kept), and the three first-pass counts (clip, disc, unmap).

    rec: columns flag, tid, pos, mapq, mtid, mpos, tlen, lclip, rclip,
    pair (FASTQ row) and first (mate 1); gaps: scaffold, start, end
    (scaffold-local)."""
    wtid, wstart, wend, wgap, wedge = gap_windows(
        gaps["scaffold"], gaps["start"], gaps["end"], dist2)
    r, w = hits(rec["tid"], rec["pos"], wtid, wstart, wend)
    flag, mapq, pos = rec["flag"][r], rec["mapq"][r], rec["pos"][r]
    tid, mtid, tlen = rec["tid"][r], rec["mtid"][r], rec["tlen"][r]
    edge, gap = wedge[w], wgap[w]
    gs, ge = gaps["start"][gap], gaps["end"][gap]
    in_zone = np.where(edge == 0, pos >= gs - clip_dist - 1,
                       pos <= ge + clip_dist - 1)
    clipped = np.where(edge == 0, rec["rclip"][r] > 0, rec["lclip"][r] > 0)
    clip = in_zone & clipped
    self_mapped = (flag & 0x4) == 0
    mate_mapped = (flag & 0x8) == 0
    cross = (mtid != tid) | (mtid < 0)
    far = np.abs(tlen) >= dist2
    len_disc = (far | (np.abs(tlen) <= dist1)) if short_insert else far
    disc = self_mapped & mate_mapped & (mapq >= anchor_mapq) & \
        (cross | len_disc)
    unmap = self_mapped & ~mate_mapped
    side_self = np.where(rec["first"][r], 0, 1)
    hq = mapq == hq_mapq
    row = rec["pair"][r]
    parts = [(gap[m], s[m], row[m], hq[m]) for m, s in (
        (clip, side_self), (disc, 1 - side_self), (unmap, 1 - side_self))]
    counts = (int(clip.sum()), int(disc.sum()), int(unmap.sum()))

    # the low-mapq pass around the discordant records' mates
    mt, mp, mg = mtid[disc], rec["mpos"][r][disc], gap[disc]
    keep = mt >= 0
    if low_mapq_pass and keep.any():
        mw = np.unique(np.stack([mt[keep], mp[keep], mg[keep]]), axis=1)
        zero = np.flatnonzero(rec["mapq"] == 0)
        r2, w2 = hits(rec["tid"][zero], rec["pos"][zero], mw[0],
                      mw[1] - LOW_MAPQ_BEFORE, mw[1] + LOW_MAPQ_AFTER)
        if len(r2):
            # the largest covering mate position wins, with all its gaps
            best = np.full(len(zero), -1, np.int64)
            np.maximum.at(best, r2, mw[1][w2])
            win = mw[1][w2] == best[r2]
            r2, w2 = zero[r2[win]], w2[win]
            parts.append((mw[2][w2], np.where(rec["first"][r2], 0, 1),
                          rec["pair"][r2], np.zeros(len(r2), bool)))
    gap_a, side_a, row_a, hq_a = (np.concatenate(x) for x in zip(*parts))
    return (gap_a.astype(np.int64), side_a.astype(np.int64),
            row_a.astype(np.int64), hq_a.astype(bool)), counts


def union(gap, side, row, hq):
    """Unique (gap, side, row) with hq OR-ed over duplicates, sorted by
    (gap, side, row)."""
    if not len(gap):
        z = np.zeros(0, np.int64)
        return z, z, z, np.zeros(0, bool)
    u, inv = np.unique(np.stack([gap, side, row]), axis=1,
                       return_inverse=True)
    inv = inv.reshape(-1)
    hq_u = np.zeros(u.shape[1], bool)
    np.logical_or.at(hq_u, inv, hq)
    return u[0], u[1], u[2], hq_u


def recruits(libraries, gaps, *, clip_dist: int, anchor_mapq: int,
             hq_mapq: int, long_insert_threshold: int,
             low_mapq_pass: bool = True) -> dict:
    """Every library's recruits as columns gap, side, lib, row, hq,
    lexsorted by (gap, lib, side, row). libraries: dicts with "insert",
    "std" and "records"."""
    cols = {k: [] for k in ("gap", "side", "lib", "row", "hq")}
    for li, lib in enumerate(libraries):
        (g, s, r, h), _ = classify(
            lib["records"], gaps, dist1=lib["insert"] - 3 * lib["std"],
            dist2=lib["insert"] + 3 * lib["std"], clip_dist=clip_dist,
            anchor_mapq=anchor_mapq, hq_mapq=hq_mapq,
            short_insert=lib["insert"] < long_insert_threshold,
            low_mapq_pass=low_mapq_pass)
        g, s, r, h = union(g, s, r, h)
        for k, v in zip(("gap", "side", "lib", "row", "hq"),
                        (g, s, np.full(len(g), li), r, h)):
            cols[k].append(v)
    out = {k: np.concatenate(v) for k, v in cols.items()}
    order = np.lexsort((out["row"], out["side"], out["lib"], out["gap"]))
    return {k: v[order] for k, v in out.items()}


def both_unmapped(libraries) -> set:
    """(lib, side, row) of both reads of every pair whose records are
    both unmapped (flag & 12 == 12)."""
    out = set()
    for li, lib in enumerate(libraries):
        rec = lib["records"]
        for row in np.unique(rec["pair"][(rec["flag"] & 12) == 12]):
            out.add((li, 0, int(row)))
            out.add((li, 1, int(row)))
    return out


def gap_fastqs(rec, libraries, gap_names, hq_only: bool = False) -> dict:
    """The reads of each gap as FASTQ text, GAPPadder's layout: one file
    a gap that recruits any read, the reads in (lib, side, row) order,
    each named '<name>_1' or '<name>_2' after its side. Returns
    {file name: bytes}."""
    sel = rec["hq"] if hq_only else np.ones(len(rec["gap"]), bool)
    out = {}
    for g in np.unique(rec["gap"][sel]):
        m = np.flatnonzero(sel & (rec["gap"] == g))
        parts = []
        for li, side, row in zip(rec["lib"][m], rec["side"][m],
                                 rec["row"][m]):
            lib = libraries[li]
            name = lib["names"][row].tobytes()
            seq = np.frombuffer(b"ACGTN", np.uint8)[lib["seq"][side, row]]
            parts.append(b"@" + name + (b"_1" if side == 0 else b"_2")
                         + b"\n" + seq.tobytes() + b"\n+\n"
                         + lib["qual"][side, row].tobytes() + b"\n")
        out[f"{gap_names[g]}.fastq"] = b"".join(parts)
    return out
