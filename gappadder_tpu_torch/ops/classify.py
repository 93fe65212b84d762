"""Read classification against gap focal windows (counterpart of
gappadder_tpu/ops/classify.py: `build_gap_windows`, `classify_reads`,
`classify_lowmapq`).

Coordinates are 0-based; the shifts reproduce the reference's mix of
1-based SAM positions and 0-based gap coordinates.

  edge 0 (left of gap):  pos in [gstart - dist2, gstart - 1],
                         clip zone pos >= gstart - clip_dist - 1
  edge 1 (right of gap): pos in [gend - 1, gend + dist2 - 2],
                         clip zone pos <= gend + clip_dist - 1

  clip:  edge 0 & right-clipped | edge 1 & left-clipped, in the clip
         zone; recruits the read itself
  disc:  both mapped, mapq >= anchor_mapq, mate on another scaffold or
         |tlen| >= dist2 (short-insert libraries also |tlen| <= dist1);
         recruits the mate
  unmap: read mapped, mate unmapped; recruits the mate

  low-mapq pass: reads with mapq == 0 whose position lies in
  [mp - 199, mp + 299] of a recorded discordant mate position mp; where
  several mate windows cover the position, only the largest mp wins
  (the reference's dict overwrite); recruits the read itself.
"""

from __future__ import annotations

import torch

from .intervals import interval_join


def build_gap_windows(gap_scaffold, gap_start, gap_end, dist2: int,
                      clip_dist: int):
    """Window table, 2 rows per gap (edge 0, edge 1), 0-based bounds:
    dict of int32 tensors [2G] tid, start, end, gap, edge (unsorted)."""
    del clip_dist
    g = gap_scaffold.shape[0]
    dev = gap_scaffold.device
    i32 = torch.int32
    tid = gap_scaffold.to(i32).repeat(2)
    start = torch.cat([gap_start - dist2, gap_end - 1]).to(i32)
    end = torch.cat([gap_start - 1, gap_end + dist2 - 2]).to(i32)
    gap = torch.arange(g, dtype=i32, device=dev).repeat(2)
    edge = torch.cat([torch.zeros(g, dtype=i32, device=dev),
                      torch.ones(g, dtype=i32, device=dev)])
    return {"tid": tid, "start": start, "end": end, "gap": gap, "edge": edge}


def classify_reads(tid, pos, flag, mapq, mtid, mpos, tlen, lclip, rclip,
                   wtid, wstart, wend, wgap, wedge, gap_start, gap_end,
                   *, dist1: int, dist2: int, clip_dist: int,
                   anchor_mapq: int, short_insert: bool, fanout: int = 8):
    """Classify one batch of alignment records against windows sorted
    by (tid, start). Returns a dict of [N, K] tensors: widx, gap (-1
    where no hit), clip / disc / unmap masks, side_self / side_mate
    (0 = left FASTQ, 1 = right)."""
    del mpos
    widx = interval_join(tid, pos, wtid, wstart, wend, fanout=fanout)
    hit = widx >= 0
    wc = widx.clamp(0, wtid.shape[0] - 1)
    edge = wedge[wc]
    gap = wgap[wc].to(torch.int64)
    gs = gap_start[gap.clamp(0, gap_start.shape[0] - 1)]
    ge = gap_end[gap.clamp(0, gap_end.shape[0] - 1)]

    pos_k = pos[:, None]
    in_c = torch.where(edge == 0, pos_k >= gs - clip_dist - 1,
                       pos_k <= ge + clip_dist - 1)

    is_first = (flag & 0x40) != 0
    self_mapped = (flag & 0x4) == 0
    mate_mapped = (flag & 0x8) == 0

    clip_ok = torch.where(edge == 0, (rclip > 0)[:, None],
                          (lclip > 0)[:, None])
    clip = hit & in_c & clip_ok

    cross = (mtid != tid) | (mtid < 0)
    far = torch.abs(tlen) >= dist2
    near = torch.abs(tlen) <= dist1
    len_disc = (far | near) if short_insert else far
    disc1 = self_mapped & mate_mapped & (mapq >= anchor_mapq) & \
        (cross | len_disc)
    disc = hit & disc1[:, None]
    unmap = hit & (self_mapped & ~mate_mapped)[:, None]

    side_self = torch.where(is_first, 0, 1).to(torch.int32)[:, None] \
        .expand(widx.shape)
    return {"widx": widx,
            "gap": torch.where(hit, gap, torch.full_like(gap, -1)),
            "clip": clip, "disc": disc, "unmap": unmap,
            "side_self": side_self, "side_mate": 1 - side_self}


def classify_lowmapq(tid, pos, flag, mapq, mwtid, mwstart, mwend, mwgap,
                     mwpos, fanout: int = 8):
    """The low-mapq second pass against the discordant mate windows
    (one row per (mate window, linked gap), sorted by (tid, start),
    INT_MAX padded; `mwpos` is the recorded mate position).

    Returns (gap [N, K], -1 where no window wins; side_self [N])."""
    eligible = mapq == 0          # reference: `if map_quality>0: continue`
    widx = interval_join(tid, pos, mwtid, mwstart, mwend, fanout=fanout)
    hit = (widx >= 0) & eligible[:, None]
    wc = widx.clamp(0, mwtid.shape[0] - 1)
    neg = torch.full_like(widx, -1)
    mp = torch.where(hit, mwpos[wc].to(torch.int64), neg)
    best = mp.max(dim=1, keepdim=True).values
    keep = hit & (mp == best)
    gap = torch.where(keep, mwgap[wc].to(torch.int64), neg)
    side_self = torch.where((flag & 0x40) != 0, 0, 1).to(torch.int32)
    return gap.to(torch.int32), side_self
