"""Collect stage: recruit the reads of each gap from each library
(counterpart of gappadder_tpu/pipeline/collect.py).

Per library, on the device: every alignment record near a gap is
classified against the gap windows (clip / discordant / mate-unmapped;
pass 1, the fused step's `_classify_extract`), the mapq-0 records near
the discordant mates' positions are classified in a second pass (pass
2, `classify_lowmapq`), and all recruitment entries are deduplicated
and joined to the library's FASTQ name tables (`recruit_on_device`).
The host decodes the BAM and indexes the FASTQs, prefilters the records
that lie in some window, builds the windows of pass 2 and merges the
libraries. A configured `tpu.mesh_shape` (when the processes hold that
many shards) splits each pass-1 batch over the mesh's shards; the
entries come back in shard order, which is the records' order, so the
result is the one-device result.

Workspace outputs:
  recruits.npz        columns gap, side, lib, row (FASTQ row in that
                      library's left/right file), hq (mapq == 60 flag),
                      lexsorted by (gap, lib, side, row)
  both_unmapped.npz   columns lib, side, row of the pairs with both
                      reads unmapped (flag & 12 == 12), for rescue
  merged/gap_reads/<gap_id>.fastq and merged/gap_reads_high_quality/
  (write_parity_files=True; the reference's layout, @name_1/_2)
"""

from __future__ import annotations

import os
import sys

import numpy as np
import torch

from .. import entry_device
from ..parallel.mesh import local_mesh, make_mesh_if_configured
from ..config import Config
from ..io import bam as bam_io
from ..io import fasta, fastq, native
from ..ops import classify, intervals, recruit
from ..utils.meters import span
from .preprocess import gap_ids
from .workspace import Workspace, config_hash

# BAMs above this many bytes decode through the native streaming reader,
# which holds one BGZF block at a time: peak memory is the columnar
# output (~52 B a record), not the whole decompressed file
STREAM_THRESHOLD = 1 << 28
INT_MAX = np.int32(0x7FFFFFFF)
# the padding rows of a batch: tid -2 lies in no window
PAD_ROW = np.array([-2, -1, 0, 0, -2, -1, 0, 0, 0, 0, 0], np.int64)
PAD_ROW_LOWMAPQ = np.array([-2, -1, 0, 255], np.int32)
# pass 2's first compaction cap (it grows on overflow)
LOWMAPQ_ECAP = 1 << 14
COLUMNS = ("tid", "pos", "flag", "mapq", "mtid", "mpos", "tlen", "lclip",
           "rclip", "nmatch", "read_len", "name_hash")


def read_bam_any(path: str) -> bam_io.Alignments:
    """The native decoder when the library loads (streamed above
    STREAM_THRESHOLD bytes), else the pure-Python reader."""
    if os.path.getsize(path) > STREAM_THRESHOLD:
        gen = native.stream_bam_native(path)
        if gen is not None:
            chunks = list(gen)
            if chunks:
                cat = {k: np.concatenate([getattr(c, k) for c in chunks])
                       for k in COLUMNS}
                return bam_io.Alignments(refs=chunks[0].refs, names=None,
                                         **cat)
    aln = native.read_bam_native(path)
    return aln if aln is not None else bam_io.read_bam(path)


def read_fastq_any(path: str) -> fastq.ReadSet:
    rs = native.read_fastq_native(path)
    return rs if rs is not None else fastq.read_fastq(path)


def _pad_windows(cols: dict[str, np.ndarray], pad_to_multiple: int = 256):
    n = len(cols["tid"])
    m = max(pad_to_multiple, -(-n // pad_to_multiple) * pad_to_multiple)
    out = {}
    for k, v in cols.items():
        pad_val = INT_MAX if k in ("tid", "start") else 0
        a = np.full(m, pad_val, np.int32)
        a[:n] = v
        out[k] = a
    return out


def _tid_map(refs: list[str], names: list[str]) -> np.ndarray:
    """BAM tid -> scaffold index in genome order (-1 if unknown)."""
    lookup = {n: i for i, n in enumerate(names)}
    missing = [r for r in refs if r not in lookup]
    if missing and len(missing) == len(refs):
        print(f"[collect] WARNING: none of the BAM's {len(refs)} reference "
              f"names match the draft genome's scaffold names (e.g. BAM "
              f"{missing[0]!r} vs draft {names[0]!r}); no reads can be "
              f"recruited — is this BAM aligned to this draft?",
              file=sys.stderr)
    return np.array([lookup.get(r, -1) for r in refs] + [-1], np.int32)


def _focal_candidate_rows(tid, pos, wtid, wstart, wend):
    """Ascending indices of the records whose (tid, pos) lies inside
    some window: the only records the join (wstart <= pos <= wend, same
    tid) can classify. Exact: the windows are merged into maximal
    intervals, and the device applies the precise join afterwards."""
    if len(wtid) == 0:
        return np.zeros(0, np.int64)
    order = np.lexsort((wstart, wtid))
    SH = np.int64(1) << 34
    ks = wtid[order].astype(np.int64) * SH + wstart[order]
    ke = wtid[order].astype(np.int64) * SH + wend[order]
    run_e = np.maximum.accumulate(ke)
    new = np.ones(len(ks), bool)
    new[1:] = ks[1:] > run_e[:-1]
    ms = ks[new]
    grp = np.cumsum(new) - 1
    me = np.full(int(grp[-1]) + 1, np.iinfo(np.int64).min, np.int64)
    np.maximum.at(me, grp, ke)
    key = np.asarray(tid, np.int64) * SH + np.asarray(pos, np.int64)
    i = np.searchsorted(ms, key, side="right") - 1
    ok = (i >= 0) & (key <= me[np.clip(i, 0, len(me) - 1)])
    return np.flatnonzero(ok)


def _compact(valid, cols, ecap: int):
    """The first `ecap` rows of `cols` (int64 [n] each) in a stable
    valid-first order, padded to ecap, under a row holding the valid
    count: int64 [ecap + 1, len(cols)]. A count above ecap means the
    rows were cut, and the caller redoes the batch with a larger cap."""
    order = torch.argsort((~valid).to(torch.uint8), stable=True)[:ecap]
    packed = torch.stack([c[order] for c in cols], dim=1)
    if packed.shape[0] < ecap:
        packed = torch.cat([packed, packed.new_zeros(
            (ecap - packed.shape[0], len(cols)))])
    count = valid.sum().reshape(1, 1).expand(1, len(cols))
    return torch.cat([count, packed])


def make_extract_step(dims, mesh, ecap: int = 1 << 15):
    """Pass 1 on one batch: the fused step's classification block
    (`parallel.slice._classify_extract`) and then the compaction of the
    valid entries on the device. The returned fn(mat, *windows) takes
    an int64 [B, 11] batch (tid, pos, flag, mapq, mtid, mpos, tlen,
    lclip, rclip and the name hash's high and low 32-bit words as
    values) and the padded window and gap columns, and returns (packed,
    counts3), each a ShardedArray over `mesh`: the batch is split over
    its shards and the windows replicated, and each shard packs
    `_compact`'s [ecap + 1, 7] of rows (gap, side, hash_hi, hash_lo, hq,
    mate_tid, mate_pos) in entry order, so packed's global array
    (`mp.to_np`) is [n_shards * (ecap + 1), 7], shard after shard, each
    block with its own count row, and counts3's [n_shards * 3]."""
    from ..parallel import slice as sl
    from ..parallel.mesh import DP, REP, shard_map

    def fn(mat, *windows, coll):
        del coll   # a shard's classification runs no collective
        cols = [mat[:, i].to(torch.int32) for i in range(9)]
        (gap, side, hi, lo, hq, valid), (mt, mp), c3 = sl._classify_extract(
            *cols, mat[:, 9], mat[:, 10], *windows, dims=dims,
            with_mates=True)
        return _compact(valid, [x.to(torch.int64) for x in
                                (gap, side, hi, lo, hq, mt, mp)], ecap), c3

    return shard_map(fn, mesh, (DP,) + (REP,) * 7, (DP, DP))



def _lowmapq_compact(mat, windows, *, fanout: int, ecap: int):
    """Pass 2 on one batch (int32 [B, 4]: tid, pos, flag, mapq) against
    the mate windows: `_compact`'s [ecap + 1, 3] of rows (gap, side,
    row in the batch)."""
    gk, sd = classify.classify_lowmapq(mat[:, 0], mat[:, 1], mat[:, 2],
                                       mat[:, 3], *windows, fanout=fanout)
    flat = gk.reshape(-1).to(torch.int64)
    rowi = torch.div(torch.arange(flat.shape[0], device=flat.device),
                     fanout, rounding_mode="floor")
    return _compact(flat >= 0, [flat, sd.to(torch.int64)[rowi], rowi], ecap)


class _Entries:
    """Recruitment entries gathered batch by batch."""

    def __init__(self):
        self.gap, self.side, self.hash, self.hq = [], [], [], []
        self.n = 0

    def add(self, gap, side, name_hash, hq):
        self.n += len(gap)
        self.gap.append(gap)
        self.side.append(side)
        self.hash.append(name_hash)
        self.hq.append(hq)


def _pass1(sub_mat, windows, dims, batch: int, ecap: int, ent: _Entries,
           mesh, sp):
    """Pass 1 over the focal candidates (`sub_mat`, int64 [n, 11]) in
    batches of `batch` records (rounded up to a multiple of the mesh's
    shards), in order, each batch split over the mesh's shards.
    Returns the discordant entries' (mate_tid, mate_pos, gap) columns.
    A compaction that overflows on any shard grows the cap of every
    shard and redoes the batch (one batch is in flight at a time),
    counted as a retry on the span `sp`."""
    from ..parallel import mp
    n_shards = mesh.n_shards
    batch = -(-batch // n_shards) * n_shards
    mates = ([], [], [])
    extract = make_extract_step(dims, mesh, ecap)
    for lo in range(0, len(sub_mat), batch):
        hi = min(lo + batch, len(sub_mat))
        mat = sub_mat[lo:hi]
        if hi - lo < batch:
            mat = np.concatenate([mat, np.broadcast_to(
                PAD_ROW, (batch - (hi - lo), len(PAD_ROW)))])
        mat = torch.from_numpy(np.ascontiguousarray(mat))
        while True:
            packed = mp.to_np(extract(mat, *windows)[0])
            stride = ecap + 1              # count row + ecap entries
            nv = packed[::stride, 0][:n_shards]
            if int(nv.max()) <= ecap:
                break
            # the compaction overflowed: grow the cap, redo this batch
            ecap = 1 << (int(nv.max()) - 1).bit_length()
            extract = make_extract_step(dims, mesh, ecap)
            sp.add(retries=1)
        for sh in range(n_shards):
            cnt = int(nv[sh])
            if cnt == 0:
                continue
            seg = packed[sh * stride + 1:sh * stride + 1 + cnt]
            eg = seg[:, 0]
            ent.add(eg, seg[:, 1], (seg[:, 2].astype(np.uint64)
                                    << np.uint64(32))
                    | seg[:, 3].astype(np.uint64), seg[:, 4].astype(bool))
            # mate fields are -1 outside the disc third; a valid disc
            # entry carries its mate's scaffold (-1 when the draft lacks
            # it)
            dsel = seg[:, 5] >= 0
            if dsel.any():
                for out, col in zip(mates, (seg[:, 5], seg[:, 6], eg)):
                    out.append(col[dsel])
    return tuple(np.concatenate(m) if m else np.zeros(0, np.int64)
                 for m in mates)


def _mate_windows(mt, mp, mg):
    """Pass 2's windows [mp - 199, mp + 299] of the distinct (mate tid,
    mate pos, gap) rows, and the fanout it needs: only the largest
    covering mate position wins, always the last window starting at or
    before the read, so the fanout spans one (tid, mp) group of linked
    gaps. Returns (windows dict of numpy columns, fanout)."""
    uniq = np.unique(np.stack([mt, mp, mg]), axis=1)
    mt, mp, mg = uniq
    _, cnts = np.unique(np.stack([mt, mp]), axis=1, return_counts=True)
    fan2 = min(int(cnts.max()) + 1, max(1, len(mt)))
    return {"tid": mt, "start": mp - 199, "end": mp + 299, "gap": mg,
            "mp": mp}, fan2


def _pass2(aln, tid, windows, fan2: int, batch: int, device,
           ent: _Entries, sp):
    """Pass 2 over the mapq-0 records only (the reference skips every
    record with mapq > 0), in batches of `batch`; a batch redone at a
    grown compaction cap is counted as a retry on the span `sp`."""
    ecap = LOWMAPQ_ECAP
    rows0 = np.flatnonzero(np.asarray(aln.mapq) == 0)
    n0 = len(rows0)
    sub_cols = [np.asarray(x, np.int32)[rows0]
                for x in (tid, aln.pos, aln.flag, aln.mapq)]
    lo = 0
    while lo < n0:
        hi = min(lo + batch, n0)
        take = rows0[lo:hi]
        mat2 = np.empty((batch, 4), np.int32)
        mat2[:] = PAD_ROW_LOWMAPQ
        for i in range(4):
            mat2[:hi - lo, i] = sub_cols[i][lo:hi]
        packed = _lowmapq_compact(
            torch.from_numpy(mat2).to(device), windows, fanout=fan2,
            ecap=ecap).cpu().numpy()
        cnt = int(packed[0, 0])
        if cnt > ecap:
            ecap = 1 << (cnt - 1).bit_length()
            sp.add(retries=1)
            continue                       # redo the batch, bigger cap
        seg = packed[1:1 + cnt]
        seg = seg[seg[:, 2] < hi - lo]     # drop the padding rows
        if len(seg):
            ent.add(seg[:, 0], seg[:, 1], aln.name_hash[take][seg[:, 2]],
                    np.zeros(len(seg), bool))   # mapq 0: not HQ
        lo = hi


def _host_union(gap_a, side_a, hash_a, hq_a, left, right):
    """The union as host numpy (the oracle of `recruit_on_device`):
    FASTQ rows by a binary search of the sorted name hashes, dedup of
    (gap, row) with the hq flags OR-ed."""
    out_gap, out_side, out_row, out_hq = [], [], [], []
    for side_val, rs in ((0, left), (1, right)):
        sel = side_a == side_val
        if not sel.any() or rs is None or rs.n == 0:
            continue
        order = np.argsort(rs.name_hash, kind="stable")
        sh = rs.name_hash[order]
        idx = np.searchsorted(sh, hash_a[sel])
        idx = np.clip(idx, 0, len(sh) - 1)
        found = sh[idx] == hash_a[sel]
        rows = order[idx][found]
        gsel = gap_a[sel][found]
        hqsel = hq_a[sel][found]
        key = gsel * (rs.n + 1) + rows
        uk, inv = np.unique(key, return_inverse=True)
        hq_u = np.zeros(len(uk), bool)
        np.logical_or.at(hq_u, inv, hqsel)
        out_gap.append(uk // (rs.n + 1))
        out_row.append(uk % (rs.n + 1))
        out_side.append(np.full(len(uk), side_val, np.int64))
        out_hq.append(hq_u)
    if not out_gap:
        z = np.zeros(0, np.int32)
        return {"gap": z, "side": z, "row": z, "hq": np.zeros(0, bool)}
    return {"gap": np.concatenate(out_gap).astype(np.int32),
            "side": np.concatenate(out_side).astype(np.int32),
            "row": np.concatenate(out_row).astype(np.int32),
            "hq": np.concatenate(out_hq)}


def collect_library(cfg: Config, lib, gaps: dict[str, np.ndarray],
                    scaffold_names: list[str], aln: bam_io.Alignments,
                    left, right, use_device_union: bool = True,
                    initial_ecap: int = 1 << 15, device="cuda", mesh=None):
    """Classify one library's records on `device` (the card unless the
    caller asks for "cpu"), pass 1 over `mesh`'s shards (default: the
    one shard of `mesh.local_mesh(device)`). Returns 1-D numpy arrays gap, side, row (the row of the
    side's read set) and hq (bool). `use_device_union=False` takes the
    host numpy union (`_host_union`) in place of
    `recruit_on_device`."""
    device = entry_device(device, "collect_library")
    if mesh is None:
        mesh = local_mesh(device)
    from ..parallel.slice import SliceDims
    dist1 = lib.insert_size - 3 * lib.std
    dist2 = lib.insert_size + 3 * lib.std
    short_insert = lib.insert_size < cfg.long_insert_threshold

    G = len(gaps["start"])
    tmap = _tid_map(aln.refs, scaffold_names)
    tid = tmap[np.clip(aln.tid, -1, len(aln.refs) - 1)]
    mtid = tmap[np.clip(aln.mtid, -1, len(aln.refs) - 1)]
    gap_start = gaps["local_start"].astype(np.int32)
    gap_end = gaps["local_end"].astype(np.int32)

    def on(a):
        return torch.from_numpy(np.ascontiguousarray(a)).to(device)

    ent = _Entries()
    with torch.no_grad():
        with span("collect.windows"):
            win = classify.build_gap_windows(
                on(gaps["scaffold"].astype(np.int32)), on(gap_start),
                on(gap_end), dist2, cfg.clip_dist)
            wcols = {k: v.cpu().numpy() for k, v in win.items()}
            fanout = min(2 * G if G else 1,
                         max(4, intervals.max_overlap_np(
                             wcols["tid"], wcols["start"], wcols["end"])))
            wsorted = intervals.sort_windows(*(win[k] for k in (
                "tid", "start", "end", "gap", "edge")))
            wp = _pad_windows({k: v.cpu().numpy() for k, v in zip(
                ("tid", "start", "end", "gap", "edge"), wsorted)})
            windows = tuple(on(wp[k]) for k in ("tid", "start", "end",
                                                "gap", "edge")) + \
                (on(gap_start), on(gap_end))
        dims = SliceDims(
            n_shards=1, n_gaps=max(G, 1), gaps_per_shard=max(G, 1),
            entry_cap=1, reads_per_gap=1, fanout=fanout, dist1=dist1,
            dist2=dist2, clip_dist=cfg.clip_dist,
            anchor_mapq=cfg.anchor_mapq, hq_mapq=cfg.high_quality_mapq,
            short_insert=short_insert, lib=0)

        # --- pass 1 over the records in some window ----------------------
        with span("collect.pass1") as s:
            cand = _focal_candidate_rows(tid, np.asarray(aln.pos),
                                         wcols["tid"], wcols["start"],
                                         wcols["end"])
            sub_mat = np.empty((len(cand), 11), np.int64)
            for i, x in enumerate((tid, aln.pos, aln.flag, aln.mapq, mtid,
                                   aln.mpos, aln.tlen, aln.lclip,
                                   aln.rclip)):
                sub_mat[:, i] = np.asarray(x, np.int32)[cand]
            hash_sub = np.asarray(aln.name_hash, np.uint64)[cand]
            sub_mat[:, 9] = hash_sub >> np.uint64(32)
            sub_mat[:, 10] = hash_sub & np.uint64(0xFFFFFFFF)
            B = cfg.tpu.read_batch
            n0 = ent.n
            mt, mp, mg = _pass1(sub_mat, windows, dims, B, initial_ecap,
                                ent, mesh, s)
            s.add(candidates=len(cand), entries=ent.n - n0)

        # --- pass 2: mapq-0 reads near the discordant mates --------------
        if len(mt):
            with span("collect.pass2") as s:
                mw, fan2 = _mate_windows(mt, mp, mg)
                msorted = intervals.sort_windows(*(on(mw[k]) for k in (
                    "tid", "start", "end", "gap", "mp")))
                mwp = _pad_windows({k: v.cpu().numpy() for k, v in zip(
                    ("tid", "start", "end", "gap", "mp"), msorted)})
                n0 = ent.n
                _pass2(aln, tid, tuple(on(mwp[k]) for k in (
                    "tid", "start", "end", "gap", "mp")), fan2, B, device,
                    ent, s)
                s.add(entries=ent.n - n0)

    if not ent.gap:
        z = np.zeros(0, np.int32)
        return {"gap": z, "side": z, "row": z, "hq": np.zeros(0, bool)}
    gap_a = np.concatenate(ent.gap).astype(np.int64)
    side_a = np.concatenate(ent.side).astype(np.int64)
    hash_a = np.concatenate(ent.hash)
    hq_a = np.concatenate(ent.hq)
    with span("collect.union") as s:
        if use_device_union:
            rec = recruit.recruit_on_device(gap_a, side_a, hash_a, hq_a,
                                            (left, right), device=device)
        else:
            rec = _host_union(gap_a, side_a, hash_a, hq_a, left, right)
        s.add(recruits=len(rec["gap"]))
    return rec


def _both_unmapped_rows(aln, left, right):
    """FASTQ (side, row) of the pairs with both reads unmapped
    (`samtools view -f 12`), for the round-2 rescue: lists of side and
    row columns, left rows first."""
    bu_hash = np.unique(aln.name_hash[(aln.flag & 12) == 12])
    sides, rows_out = [], []
    for side_val, rs in ((0, left), (1, right)):
        if rs is None or rs.n == 0 or not len(bu_hash):
            continue
        order = np.argsort(rs.name_hash, kind="stable")
        sh = rs.name_hash[order]
        idx = np.clip(np.searchsorted(sh, bu_hash), 0, len(sh) - 1)
        found = sh[idx] == bu_hash
        rows = order[idx][found]
        sides.append(np.full(len(rows), side_val, np.int32))
        rows_out.append(rows.astype(np.int32))
    return sides, rows_out


def run_collect(cfg: Config, ws: Workspace,
                genome: fasta.Genome | None = None,
                write_parity_files: bool = False, device="cuda"):
    """Collect every library on `device` (the card unless the caller
    asks for "cpu") and merge them; writes recruits.npz and
    both_unmapped.npz (and the per-gap FASTQs with write_parity_files).
    Returns (recruits, readsets)."""
    device = entry_device(device, "run_collect")
    gaps = ws.load_arrays("gaps")
    scaffold_names = ws.load_json("scaffold_names")
    # shard classification over a mesh when one is configured and the
    # processes hold enough shards (records split, tables replicated)
    mesh = make_mesh_if_configured(cfg, device)

    all_cols = {"gap": [], "side": [], "row": [], "hq": [], "lib": []}
    bu_cols = {"lib": [], "side": [], "row": []}
    readsets = []
    map_index = None
    for li, lib in enumerate(cfg.libraries):
        with span("collect.fastq_scan") as s:
            if lib.bam:
                # bounded memory: index the FASTQs (hashes and offsets
                # only); the recruited rows' payloads are read at assembly
                left = fastq.scan_fastq(lib.left_fq) if lib.left_fq \
                    else None
                right = fastq.scan_fastq(lib.right_fq) if lib.right_fq \
                    else None
            else:
                # self-mapping reads every payload: load them
                left = read_fastq_any(lib.left_fq) if lib.left_fq else None
                right = read_fastq_any(lib.right_fq) if lib.right_fq \
                    else None
            s.add(reads=sum(rs.n for rs in (left, right) if rs is not None))
        readsets.append((left, right))
        if lib.bam:
            with span("collect.bam_decode") as s:
                aln = read_bam_any(lib.bam)
                s.add(records=len(aln.flag))
        else:
            # self-mapping mode: no BAM, the reads are placed on the
            # draft by the minimizer mapper
            from ..ops import minimap
            if left is None or right is None:
                raise ValueError(
                    f"library {li}: self-mapping (bam=None) needs both "
                    "left/right FASTQs")
            if genome is None:
                genome = fasta.read_fasta(cfg.draft_genome)
            if map_index is None:
                map_index = minimap.build_index(genome)
            aln = minimap.map_library(genome, map_index, left, right)
        rec = collect_library(cfg, lib, gaps, scaffold_names, aln,
                              left, right, device=device, mesh=mesh)
        for k in ("gap", "side", "row", "hq"):
            all_cols[k].append(rec[k])
        all_cols["lib"].append(np.full(len(rec["gap"]), li, np.int32))
        with span("collect.both_unmapped"):
            bu_sides, bu_rows = _both_unmapped_rows(aln, left, right)
        for side, row in zip(bu_sides, bu_rows):
            bu_cols["lib"].append(np.full(len(row), li, np.int32))
            bu_cols["side"].append(side)
            bu_cols["row"].append(row)

    rec = {k: (np.concatenate(v) if v else np.zeros(0, np.int32))
           for k, v in all_cols.items()}
    order = np.lexsort((rec["row"], rec["side"], rec["lib"], rec["gap"]))
    rec = {k: v[order] for k, v in rec.items()}
    with span("collect.save"):
        ws.save_arrays("recruits", **rec)
        bu = {k: (np.concatenate(v) if v else np.zeros(0, np.int32))
              for k, v in bu_cols.items()}
        ws.save_arrays("both_unmapped", **bu)
        ws.mark_done("collect", config_hash(cfg),
                     num_recruits=int(len(rec["gap"])))

    from ..parallel import mp
    if write_parity_files and mp.is_primary():
        _write_gap_fastqs(cfg, ws, gaps, rec, readsets)
        _write_gap_fastqs(cfg, ws, gaps, rec, readsets,
                          subdir="merged/gap_reads_high_quality",
                          hq_only=True)
    return rec, readsets


def _write_gap_fastqs(cfg, ws, gaps, rec, readsets, subdir="merged/gap_reads",
                      hq_only=False):
    """The reference's layout: <subdir>/<gap_id>.fastq with the reads
    renamed <name>_1 / <name>_2. The native writer appends one run of
    (lib, side) at a time when it loads, else the Python writer writes
    record by record."""
    folder = ws.path(subdir)
    with span("collect.gap_fastqs") as s:
        os.makedirs(folder, exist_ok=True)
        ids = gap_ids(gaps)
        written = []
        sel = rec["hq"] if hq_only else np.ones(len(rec["gap"]), bool)
        # records are lexsorted by (gap, lib, side, row): one searchsorted
        # pair a gap
        gap_all = rec["gap"]
        use_native = native.available()
        for g in np.unique(gap_all[sel]):
            fpath = os.path.join(folder, f"{ids[g]}.fastq")
            lo = np.searchsorted(gap_all, g, side="left")
            hi = np.searchsorted(gap_all, g, side="right")
            m = slice(lo, hi) if not hq_only else np.flatnonzero(
                sel[lo:hi]) + lo
            written.append(fpath)
            libs, sides, rows = rec["lib"][m], rec["side"][m], rec["row"][m]
            if use_native:
                open(fpath, "w").close()
                i = 0
                while i < len(rows):
                    j = i
                    while (j < len(rows) and libs[j] == libs[i]
                           and sides[j] == sides[i]):
                        j += 1
                    rs = readsets[libs[i]][sides[i]]
                    rows_w = rows[i:j]
                    if isinstance(rs, fastq.LazyReadSet):
                        rs = rs.materialize(rows_w)
                        rows_w = np.arange(j - i)
                    ok = native.write_fastq_native(
                        fpath, rs, rows_w,
                        suffix="_1" if sides[i] == 0 else "_2", append=True)
                    if not ok:
                        raise IOError(f"native FASTQ write failed: {fpath}")
                    i = j
                continue
            with open(fpath, "w") as fh:
                for li, side, row in zip(libs, sides, rows):
                    rs = readsets[li][side]
                    fastq.write_fastq(fh, rs, [row],
                                      suffix="_1" if side == 0 else "_2")
        s.add(files=len(written),
              bytes=sum(map(os.path.getsize, written)))
