"""Recruitment union: dedup + FASTQ hash join (counterpart of
gappadder_tpu/ops/recruit.py: `_split_hash`, `dedup_and_join`,
`recruit_on_device`).

(gap, side, name-hash) records are deduplicated and joined against a
library's FASTQ name table with multi-key sorts. Hashes are 64-bit,
split into two 32-bit sort keys (held in int64 here).
"""

from __future__ import annotations

import numpy as np
import torch

from .. import entry_device
from . import psort

I32MAX = 0x7FFFFFFF


def _split_hash(h):
    h = np.asarray(h, np.uint64)
    return ((h >> np.uint64(32)).astype(np.uint32),
            (h & np.uint64(0xFFFFFFFF)).astype(np.uint32))


def dedup_and_join(rec_gap, rec_side, rec_hi, rec_lo, rec_hq,
                   tbl_hi, tbl_lo, tbl_row, tbl_side):
    """Dedup (gap, side, hash) records and resolve their FASTQ rows.

    rec_*: [R] records (gap == -1 is padding), rec_hq bool; tbl_*: the
    concatenated FASTQ name tables sorted by (side, hi, lo).
    Returns (gap, side, row, hq, valid) [R]: one entry per surviving
    unique (gap, side, hash) that found its row; hq is OR-reduced over
    duplicates."""
    R = rec_gap.shape[0]
    dev = rec_gap.device
    i64 = torch.int64
    g, s, hi, lo, hq = psort.bitonic_sort(
        (rec_gap.to(i64), rec_side.to(i64), rec_hi.to(i64), rec_lo.to(i64),
         rec_hq.to(i64)), num_keys=4)
    prev_same = (torch.roll(g, 1) == g) & (torch.roll(s, 1) == s) & \
        (torch.roll(hi, 1) == hi) & (torch.roll(lo, 1) == lo)
    prev_same[0] = False
    first = ~prev_same
    # OR of hq over each run: segment max keyed by run id
    run_id = torch.cumsum(first.to(i64), dim=0) - 1
    hq_or = torch.zeros(R, dtype=i64, device=dev).scatter_reduce_(
        0, run_id, hq, "amax", include_self=True)[run_id]
    keep = first & (g >= 0)

    # ---- join against the FASTQ table by (side, hi, lo) ----------------
    M = tbl_hi.shape[0]
    q_side = torch.where(keep, s, torch.full_like(s, I32MAX))
    tag = torch.cat([torch.zeros(M, dtype=i64, device=dev),
                     torch.ones(R, dtype=i64, device=dev)])
    k_side = torch.cat([tbl_side.to(i64), q_side])
    k_hi = torch.cat([tbl_hi.to(i64), hi])
    k_lo = torch.cat([tbl_lo.to(i64), lo])
    payload = torch.cat([torch.arange(M, device=dev),
                         torch.arange(R, device=dev)])
    trow = torch.cat([tbl_row.to(i64), torch.zeros(R, dtype=i64, device=dev)])
    rs, rhi, rlo, rtag, rpay, rrow = psort.bitonic_sort(
        (k_side, k_hi, k_lo, tag, payload, trow), num_keys=4)
    # carry the last table row and its key forward
    is_tbl = rtag == 0
    idxs = torch.arange(M + R, device=dev)
    last_tbl = torch.cummax(torch.where(is_tbl, idxs,
                                        torch.full_like(idxs, -1)),
                            dim=0).values
    lt = last_tbl.clamp(0, M + R - 1)
    matched = (last_tbl >= 0) & (rs[lt] == rs) & (rhi[lt] == rhi) & \
        (rlo[lt] == rlo)
    row_here = torch.where(matched, rrow[lt], torch.full_like(rrow, -1))
    tgt = torch.where(~is_tbl, rpay, torch.full_like(rpay, R))
    row_of = torch.full((R + 1,), -1, dtype=i64, device=dev).scatter_(
        0, tgt, row_here)[:R]

    valid = keep & (row_of >= 0)
    return (torch.where(valid, g, torch.full_like(g, -1)), s, row_of,
            hq_or.to(torch.bool), valid)


def recruit_on_device(entries_gap, entries_side, entries_hash, entries_hq,
                      readsets, device="cuda"):
    """Collect's union of one library on `device` (the card unless the
    caller asks for "cpu"): the recruitment entries (numpy: gap, side,
    uint64 name hash, hq) deduplicated and joined to the concatenated
    left + right FASTQ name tables of `readsets` by `dedup_and_join`.

    Returns numpy gap / side / row (int32) and hq (bool), lexsorted by
    (gap, side, row)."""
    device = entry_device(device, "recruit_on_device")
    z = np.zeros(0, np.int32)
    empty = {"gap": z, "side": z, "row": z, "hq": np.zeros(0, bool)}
    if len(entries_gap) == 0:
        return empty
    tbl_hi, tbl_lo, tbl_row, tbl_side = [], [], [], []
    for side_val, rs in ((0, readsets[0]), (1, readsets[1])):
        if rs is None or rs.n == 0:
            continue
        hi, lo = _split_hash(rs.name_hash)
        tbl_hi.append(hi)
        tbl_lo.append(lo)
        tbl_row.append(np.arange(rs.n, dtype=np.int32))
        tbl_side.append(np.full(rs.n, side_val, np.int32))
    if not tbl_hi:
        return empty
    hi, lo = _split_hash(entries_hash)

    def on(a, dtype=np.int64):
        return torch.from_numpy(np.asarray(a).astype(dtype)).to(device)

    with torch.no_grad():
        res = dedup_and_join(
            on(entries_gap), on(entries_side), on(hi), on(lo),
            on(entries_hq, bool), on(np.concatenate(tbl_hi)),
            on(np.concatenate(tbl_lo)), on(np.concatenate(tbl_row)),
            on(np.concatenate(tbl_side)))
    g, s, row, hq, m = (x.cpu().numpy() for x in res)
    out = {"gap": g[m].astype(np.int32), "side": s[m].astype(np.int32),
           "row": row[m].astype(np.int32), "hq": hq[m]}
    order = np.lexsort((out["row"], out["side"], out["gap"]))
    return {k: v[order] for k, v in out.items()}
