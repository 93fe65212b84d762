"""The fused collect->assemble->pick step (counterpart of
gappadder_tpu/parallel/slice.py::_step), on one device or over the
shards of a mesh.

  block 1  classify alignment records against the gap windows and
           flatten the hits into recruitment entries;
  block 2  route the entries to the gap's home shard (gap % n_shards;
           with one shard a stable valid-first compaction), dedup +
           join them to the FASTQ name table, group the reads per gap;
  block 3  count each gap's distinct canonical k-mers for every k and
           assemble de-Bruijn unitigs for every (k, sub_k);
  block 4  score both flanks (forward and revcomp) against every contig
           with local Smith-Waterman — the hand-written CUDA kernel
           `csrc/sw.cu` on the card.

`run_step` is the one-device entry point. It returns the same 12
outputs, in the same order and dtypes, as the JAX step. Its state is
the 28 input arrays of `example_data` and a `SliceDims`;
`inputs_from_numpy` and `dims_from_fields` bring the JAX package's
inputs across unchanged. `make_slice_step(mesh, dims)` runs the step
over a mesh (`parallel/mesh.py`): the alignment records and name hashes
split over the shards, the tables, read store and flanks replicated;
counts and the k-mer histogram summed over the shards, the capacity
indicators maxed, and the other outputs each shard's, in shard order,
as the JAX step's shard_map outputs are. Gap g lives on shard g % N at
local slot g // N (`home_of`).
"""

from __future__ import annotations

import dataclasses
import functools

import numpy as np
import torch

from .. import dna, entry_device
from ..io.fastq import ReadSet
from ..ops import dbg, kmers, psort
from ..ops.classify import build_gap_windows, classify_reads
from ..ops.dbg import HIST_BUCKETS
from ..ops.intervals import sort_windows
from ..ops.recruit import dedup_and_join
from ..ops.sw_cuda import sw_batch_cuda
from ..ops.sw_host import BWA_PARAMS
from ..pipeline.assemble import (FULL, _merge_chunk, _merge_chunk_nocnt,
                                 filter_min_count)
from . import dist
from .mesh import DP, REP, Sharding, as_tensor, place, shard_map


@dataclasses.dataclass(frozen=True)
class SliceDims:
    """Static shape/config bundle of the step (the JAX SliceDims without
    `use_pallas` and `route_impl`: the port has one SW kernel and one
    route, the dense one)."""
    n_shards: int
    n_gaps: int          # global gap count G
    gaps_per_shard: int  # Gl = ceil(G / n_shards)
    entry_cap: int       # recruit-entry receive capacity E
    reads_per_gap: int   # R
    kset: tuple[tuple[int, int], ...] = ((17, 15),)
    max_distinct: int = 256
    node_cap: int = 0    # 0 = auto: next_pow2(2*max_distinct + 4*k)
    max_unitigs: int = 4
    max_contig_len: int = 512
    min_contig_len: int = 40
    min_kmer_count: int = 0
    pop_bubbles: int = 0
    fixed_kmer_cap: bool = False
    fanout: int = 4
    dist1: int = 210
    dist2: int = 390
    clip_dist: int = 250
    anchor_mapq: int = 30
    hq_mapq: int = 60
    short_insert: bool = True
    lib: int = 0

    def effective_node_cap(self, k: int) -> int:
        """The DBG node/edge cap used for setting k."""
        if self.node_cap:
            return self.node_cap
        return 1 << (2 * self.max_distinct + 4 * k - 1).bit_length()

    @property
    def n_contigs(self) -> int:
        """Contig slots per gap: len(kset) * max_unitigs."""
        return len(self.kset) * self.max_unitigs


def dims_from_fields(fields: dict) -> SliceDims:
    """SliceDims from a field dict (e.g. `dataclasses.asdict` of the JAX
    SliceDims); fields the port does not have are ignored."""
    names = {f.name for f in dataclasses.fields(SliceDims)}
    kw = {k: v for k, v in fields.items() if k in names}
    kw["kset"] = tuple(tuple(int(x) for x in s) for s in kw["kset"])
    return SliceDims(**kw)


def inputs_from_numpy(args, device) -> tuple:
    """The step's 28 inputs as tensors on `device`. Numpy arrays are
    converted (uint32 columns, the name hashes, become int64 holding the
    same values); tensors are moved to `device`."""
    return tuple(as_tensor(a).to(device) for a in args)


# ---------------------------------------------------------------------------
# block 1: classification + recruitment-entry extraction
# ---------------------------------------------------------------------------

def _classify_extract(tid, pos, flag, mapq, mtid, mpos, tlen, lclip, rclip,
                      name_hi, name_lo,
                      wtid, wstart, wend, wgap, wedge, gap_start, gap_end,
                      *, dims: SliceDims, with_mates: bool = False):
    """Classify records against the gap windows and flatten the hits
    into entries (gap, side, hi, lo, hq, valid); sides are FASTQ-table
    keys 2*lib + (0 left / 1 right). Returns (entries, counts3), or with
    `with_mates` (Collect's pass 1) (entries, (mate_tid, mate_pos),
    counts3): the mate columns aligned with the entries, the records'
    mtid / mpos in the disc third and -1 in the clip and unmap thirds,
    which Collect turns into its low-mapq pass-2 windows. The step does
    not build them."""
    out = classify_reads(
        tid, pos, flag, mapq, mtid, mpos, tlen, lclip, rclip,
        wtid, wstart, wend, wgap, wedge, gap_start, gap_end,
        dist1=dims.dist1, dist2=dims.dist2, clip_dist=dims.clip_dist,
        anchor_mapq=dims.anchor_mapq, short_insert=dims.short_insert,
        fanout=dims.fanout)
    counts3 = torch.stack([out[k].sum() for k in ("clip", "disc", "unmap")]
                          ).to(torch.int32)
    parts = []
    for kind, sidekey in (("clip", "side_self"), ("disc", "side_mate"),
                          ("unmap", "side_mate")):
        mask = out[kind]                       # [B, K]
        shape = mask.shape
        cols = [out["gap"], out[sidekey] + 2 * dims.lib,
                name_hi[:, None].expand(shape), name_lo[:, None].expand(shape),
                (mapq == dims.hq_mapq)[:, None].expand(shape), mask]
        if with_mates:
            for col in (mtid, mpos):
                col = col if kind == "disc" else torch.full_like(col, -1)
                cols.append(col[:, None].expand(shape))
        parts.append([c.reshape(-1) for c in cols])
    cat = [torch.cat([p[i] for p in parts]) for i in range(len(parts[0]))]
    gap, side, hi, lo, hq, valid = cat[:6]
    entries = (gap, side, hi, lo, hq, valid & (gap >= 0))
    if with_mates:
        return entries, (cat[6], cat[7]), counts3
    return entries, counts3


# ---------------------------------------------------------------------------
# block 2: routing + dedup/join + per-gap grouping
# ---------------------------------------------------------------------------

def _group_rows(gap, row, hq, valid, dims: SliceDims):
    """Scatter joined recruits into a [Gl, R] global-read-row table,
    rows within a gap by ascending row id. Rows beyond R per gap are
    dropped (highest row ids first); the pre-truncation maximum per-gap
    count is returned so the caller can detect the loss.

    Returns (rowtab int32, hqtab bool, n_reads int32 [Gl], n_raw_max)."""
    Gl, R = dims.gaps_per_shard, dims.reads_per_gap
    dev = gap.device
    lg = torch.div(gap, dims.n_shards, rounding_mode="floor")
    key = torch.where(valid, lg, torch.full_like(lg, Gl)).to(torch.int64)
    key_s, grow_s, hq_s = psort.bitonic_sort(
        (key, row.to(torch.int64), hq.to(torch.int64)), num_keys=2)
    n = key.shape[0]
    idx = torch.arange(n, device=dev)
    first = torch.ones(n, dtype=torch.bool, device=dev)
    first[1:] = key_s[1:] != key_s[:-1]
    run_start = torch.cummax(torch.where(first, idx, torch.zeros_like(idx)),
                             dim=0).values
    rank = idx - run_start
    # out-of-range (gap, rank) cells go to the dump slot Gl*R
    inb = (key_s < Gl) & (rank < R)
    flat = torch.where(inb, key_s * R + rank, torch.full_like(rank, Gl * R))
    rowtab = torch.full((Gl * R + 1,), -1, dtype=torch.int32, device=dev)
    rowtab[flat] = grow_s.to(torch.int32)
    hqtab = torch.zeros(Gl * R + 1, dtype=torch.bool, device=dev)
    hqtab[flat] = hq_s.to(torch.bool)
    counted = key_s < Gl
    n_reads = torch.zeros(Gl + 1, dtype=torch.int64, device=dev).scatter_add_(
        0, torch.where(counted, key_s, torch.full_like(key_s, Gl)),
        counted.to(torch.int64))[:Gl]
    n_raw_max = n_reads.max() if Gl else torch.zeros((), dtype=torch.int64,
                                                     device=dev)
    return (rowtab[:Gl * R].reshape(Gl, R), hqtab[:Gl * R].reshape(Gl, R),
            torch.clamp(n_reads, max=R).to(torch.int32),
            torch.clamp(n_raw_max, min=0))


def _route_and_group(entries, tbl_hi, tbl_lo, tbl_row, tbl_side,
                     *, dims: SliceDims, coll=None):
    """Route entries to their gap-home shards, dedup + FASTQ-join,
    group. Returns (rowtab, hqtab, n_reads, (raw per-gap max, raw router
    demand))."""
    gap, side, hi, lo, hq, valid = entries
    # gap-home = gap % N (no destination with one shard)
    dest = None if coll is None else torch.remainder(gap, dims.n_shards)
    (rgap, rside, rhi, rlo, rhq), _src, n_recv = dist.route_shard(
        (gap, side, hi, lo, hq.to(torch.int32)), dest, valid,
        out_cap=dims.entry_cap, fills=(-1, -1, 0, 0, -1), coll=coll)
    g2, _s2, row2, hq2, ok2 = dedup_and_join(
        rgap, rside, rhi, rlo, rhq.to(torch.bool),
        tbl_hi, tbl_lo, tbl_row, tbl_side)
    rowtab, hqtab, n_reads, n_raw_max = _group_rows(g2, row2, hq2, ok2, dims)
    return rowtab, hqtab, n_reads, (n_raw_max, n_recv[0])


# ---------------------------------------------------------------------------
# block 3: multi-(k, sub_k) distinct-k-mer count + DBG unitig assembly
# ---------------------------------------------------------------------------

def gather_reads(rowtab, reads_tbl, reads_len):
    """Each gap's read codes [Gl, R, L] and lengths [Gl, R] from the
    read store; empty slots (row -1) are all-N with length 0."""
    safe = rowtab.to(torch.int64).clamp(0, reads_tbl.shape[0] - 1)
    live = rowtab >= 0
    seq = reads_tbl[safe]
    rlen = reads_len[safe]
    return (torch.where(live[..., None], seq, torch.full_like(seq, dna.N)),
            torch.where(live, rlen, torch.zeros_like(rlen)))


def _distinct_kmers(seq, rlen, k: int, dims: SliceDims,
                    read_chunk: int = 512):
    """Distinct canonical k-mers + counts per local gap. The read axis
    is merged in chunks of `read_chunk` reads, which decides what is
    kept when the table saturates. Without a count filter or bubble
    popping the countless merge runs (same distinct set)."""
    Gl, R, _L = seq.shape
    acc = torch.full((Gl, dims.max_distinct, kmers.num_limbs(k)), FULL,
                     dtype=torch.int64, device=seq.device)
    cnt = torch.zeros(Gl, dims.max_distinct, dtype=torch.int32,
                      device=seq.device)
    if dims.min_kmer_count == 0 and dims.pop_bubbles == 0:
        for lo in range(0, R, read_chunk):
            hi = min(lo + read_chunk, R)
            acc = _merge_chunk_nocnt(seq[:, lo:hi], rlen[:, lo:hi], acc, k)
        distinct = ~torch.all(acc == FULL, dim=-1)
    else:
        for lo in range(0, R, read_chunk):
            hi = min(lo + read_chunk, R)
            acc, cnt = _merge_chunk(seq[:, lo:hi], rlen[:, lo:hi], acc, cnt,
                                    k)
        acc, cnt, distinct = filter_min_count(acc, cnt, dims.min_kmer_count)
    nk = distinct.sum(-1).to(torch.int32)
    kstr = dbg.unpack_kmers_to_strings(acc, k)
    return acc, kstr, nk, cnt, distinct


def _assemble_block(seq, rlen, dims: SliceDims):
    """All (k, sub_k) settings over the local gap batch.

    Returns (useq int8 [Gl, S*mu, Lc], ulen [Gl, S*mu], ucnt [Gl, S],
    hist [HIST_BUCKETS] of setting 0's k, (max raw nodes, max raw
    edges, max distinct) over settings). Slot s*mu + i holds setting
    s's unitig i."""
    dev = seq.device
    mu, Lc = dims.max_unitigs, dims.max_contig_len
    z = torch.zeros((), dtype=torch.int32, device=dev)
    over_nodes, over_edges, over_nk = z, z, z
    hist = torch.zeros(HIST_BUCKETS, dtype=torch.int32, device=dev)
    # the distinct-k-mer table depends only on k: once per unique k
    kcache: dict = {}
    for si, (k, _sub_k) in enumerate(dims.kset):
        if k not in kcache:
            kcache[k] = _distinct_kmers(seq, rlen, k, dims)
        acc, _kstr, nk, _kcnt, distinct = kcache[k]
        if si == 0:
            h = (acc[..., 0] >> 16) % HIST_BUCKETS
            hist = hist.index_add(
                0, torch.where(distinct, h, torch.zeros_like(h)).reshape(-1),
                distinct.reshape(-1).to(torch.int32))
        over_nk = torch.maximum(over_nk, nk.max())
    useqs, ulens, ucnts = [], [], []
    for k, sub_k in dims.kset:
        us, ul, uc, nn_raw, ne_raw = dbg.assemble_unitigs(
            kcache[k][1], kcache[k][2], kcache[k][3], k=k, sub_k=sub_k,
            max_unitigs=mu, max_len=Lc, min_len=dims.min_contig_len,
            pop_bubbles=dims.pop_bubbles,
            node_cap=dims.effective_node_cap(k),
            edge_cap=dims.effective_node_cap(k))
        useqs.append(us)
        ulens.append(ul)
        ucnts.append(uc)
        over_nodes = torch.maximum(over_nodes, nn_raw.max())
        over_edges = torch.maximum(over_edges, ne_raw.max())
    return (torch.cat(useqs, dim=1), torch.cat(ulens, dim=1),
            torch.stack(ucnts, dim=1), hist,
            (over_nodes, over_edges, over_nk))


# ---------------------------------------------------------------------------
# block 4: flank pick scoring (the pick stage's first SW pass)
# ---------------------------------------------------------------------------

def pick_inputs(useq, ulen, flank_l, flank_r, flank_ll, flank_rl):
    """The SW batch of block 4: every flank query (0 = left fwd, 1 =
    left rc, 2 = right fwd, 3 = right rc) against every contig.

    Returns (q int8 [B, FL], ql int32 [B], t int8 [B, Lc], tl int32
    [B], live bool [Gl, 4, C]) with B = Gl*4*C; empty queries and
    contigs are scored at length 1 and masked by `live`."""
    Gl, C, Lc = useq.shape
    FL = flank_l.shape[1]
    q4 = torch.stack([flank_l, dna.revcomp_t(flank_l, flank_ll),
                      flank_r, dna.revcomp_t(flank_r, flank_rl)], dim=1)
    ql4 = torch.stack([flank_ll, flank_ll, flank_rl, flank_rl], dim=1)
    q = q4[:, :, None, :].expand(Gl, 4, C, FL).reshape(-1, FL)
    ql = ql4[:, :, None].expand(Gl, 4, C).reshape(-1)
    t = useq[:, None].expand(Gl, 4, C, Lc).reshape(-1, Lc)
    tl = ulen[:, None].expand(Gl, 4, C).reshape(-1)
    live = ((ql > 0) & (tl > 0)).reshape(Gl, 4, C)
    return (torch.clamp(q, min=0).to(torch.int8).contiguous(),
            torch.clamp(ql, min=1).to(torch.int32).contiguous(),
            torch.clamp(t, min=0).to(torch.int8).contiguous(),
            torch.clamp(tl, min=1).to(torch.int32).contiguous(), live)


def _pick_score_block(useq, ulen, flank_l, flank_r, flank_ll, flank_rl):
    """Local SW (BWA_PARAMS) of both flanks, both strands, against every
    contig. Returns (score, qend, tend) int32 [Gl, 4, C]."""
    q, ql, t, tl, live = pick_inputs(useq, ulen, flank_l, flank_r, flank_ll,
                                     flank_rl)
    res = sw_batch_cuda(q, ql, t, tl, BWA_PARAMS, "local")
    z = torch.zeros(live.shape, dtype=torch.int32, device=live.device)
    return tuple(torch.where(live, r.reshape(live.shape).to(torch.int32), z)
                 for r in res)


# ---------------------------------------------------------------------------
# the fused step
# ---------------------------------------------------------------------------

def _step(tid, pos, flag, mapq, mtid, mpos, tlen, lclip, rclip,
          name_hi, name_lo,
          wtid, wstart, wend, wgap, wedge, gap_start, gap_end,
          tbl_hi, tbl_lo, tbl_row, tbl_side,
          reads_tbl, reads_len, flank_l, flank_r, flank_ll, flank_rl,
          *, dims: SliceDims, coll=None):
    """One shard's step; `coll` is its `mesh.Collectives` (None: the
    one-device step, shard 0 of 1)."""
    N = dims.n_shards
    if (1 if coll is None else coll.n) != N:
        raise ValueError(f"the step's dims hold {N} shards, the mesh "
                         f"{1 if coll is None else coll.n}")
    me = 0 if coll is None else coll.me
    # ---- block 1: classify my slice of the records ----------------------
    entries, counts3 = _classify_extract(
        tid, pos, flag, mapq, mtid, mpos, tlen, lclip, rclip,
        name_hi, name_lo,
        wtid, wstart, wend, wgap, wedge, gap_start, gap_end, dims=dims)
    counts = counts3 if coll is None else coll.psum(counts3)

    # ---- block 2: route to gap-home shards, dedup/join, group -----------
    rowtab, hqtab, n_reads, (n_raw_max, n_recv) = _route_and_group(
        entries, tbl_hi, tbl_lo, tbl_row, tbl_side, dims=dims, coll=coll)

    # ---- block 3 ---------------------------------------------------------
    seq, rlen = gather_reads(rowtab, reads_tbl, reads_len)
    useq, ulen, ucnt, hist, (o_nodes, o_edges, o_nk) = _assemble_block(
        seq, rlen, dims)
    # capacity indicators, maxed over the mesh (see check_overflow): raw
    # node/edge counts, raw per-gap recruit max, distinct-k-mer max, raw
    # router demand
    over = torch.stack([o_nodes, o_edges, n_raw_max.to(torch.int32), o_nk,
                        n_recv.to(torch.int32)]).to(torch.int32)
    if coll is not None:
        hist, over = coll.psum(hist), coll.pmax(over)

    # ---- block 4 ---------------------------------------------------------
    # home = gap % N at local slot gap // N, so slot j holds gap me + j*N
    myg = torch.arange(dims.gaps_per_shard, device=useq.device)
    if coll is not None:
        myg = me + myg * N
    myg = myg.clamp(0, dims.n_gaps - 1)
    score, qend, tend = _pick_score_block(
        useq, ulen, flank_l[myg], flank_r[myg], flank_ll[myg],
        flank_rl[myg])
    return (torch.cat([counts, over]), hist, n_recv[None].to(torch.int32),
            n_reads, rowtab, hqtab, useq, ulen, ucnt, score, qend, tend)


# _step's argument split: the first N_DP_ARGS are split over the mesh
# (alignment-record columns + name hashes), the remaining N_REP_ARGS are
# replicated (window/gap tables, FASTQ name table, read store, flanks)
N_DP_ARGS = 11
N_REP_ARGS = 17
N_OUT_DP = 10   # all outputs after (counts, hist) are per-shard
IN_SPECS = (DP,) * N_DP_ARGS + (REP,) * N_REP_ARGS
OUT_SPECS = (REP, REP) + (DP,) * N_OUT_DP


@functools.lru_cache(maxsize=64)
def make_slice_step(mesh, dims: SliceDims):
    """The fused step over `mesh` (all axes flattened as dp), cached per
    (mesh, dims) as the JAX jit is. The returned fn takes the 28 inputs
    as global values or placed ShardedArrays (`place_args`) and returns
    the 12 outputs as `mesh.ShardedArray`s (`mp.to_np` gives the global
    arrays: counts and hist replicated, the rest [N * Gl, ...] in shard
    order)."""
    return shard_map(functools.partial(_step, dims=dims), mesh, IN_SPECS,
                     OUT_SPECS)


def run_step(dims: SliceDims, args, device="cuda"):
    """Run the fused step on `device` (the card unless the caller asks
    for "cpu"). `args` are the 28 inputs of `example_data`, as numpy
    arrays or tensors; each is brought to `device` (a no-op for a
    tensor already there), so the step runs where the caller asked,
    whatever device the inputs were on. Returns the 12 outputs (counts,
    hist, n_recv, n_reads, rowtab, hqtab, useq, ulen, ucnt, score, qend,
    tend)."""
    args = inputs_from_numpy(args, entry_device(device, "run_step"))
    with torch.no_grad():
        return _step(*args, dims=dims)


def check_overflow(dims: SliceDims, counts) -> None:
    """Raise if the step's capacity indicators report truncation (every
    static cap, the router's entry_cap included)."""
    nodes, edges, raw_reads, nk, raw_recv = (int(x) for x in counts[3:8])
    ncap = min(dims.effective_node_cap(k) for k, _ in dims.kset)
    if raw_recv > dims.entry_cap:
        raise OverflowError(
            f"router receive capacity overflowed ({raw_recv} > "
            f"{dims.entry_cap} entries): raise SliceDims.entry_cap")
    if nodes > ncap or edges > ncap:
        raise OverflowError(
            f"DBG node/edge cap {ncap} overflowed ({nodes}/{edges} "
            "distinct): raise SliceDims.node_cap/max_distinct")
    if raw_reads > dims.reads_per_gap:
        raise OverflowError(
            f"per-gap read table overflowed ({raw_reads} > "
            f"{dims.reads_per_gap}): raise SliceDims.reads_per_gap")
    if nk >= dims.max_distinct:
        raise OverflowError(
            f"distinct-k-mer table saturated ({nk} == "
            f"{dims.max_distinct}): raise SliceDims.max_distinct")


def example_data(n_shards: int = 1, gaps_per_shard: int = 2, seed: int = 0,
                 read_len: int = 48, step: int = 4, flank_len: int = 96,
                 gap_len: int | tuple[int, int] = 64, kset=((17, 15),)):
    """Planted scenario: G gaps on one scaffold, clipped reads tiling
    each gap region so the DBG closes it. gap_len is fixed or an
    inclusive (lo, hi) range drawn log-uniformly (skewed gap sizes; caps
    size to the largest). Returns (dims, args) with args 28 numpy
    arrays, drawn exactly as the JAX package's example_data draws them."""
    G = n_shards * gaps_per_shard
    rng = np.random.default_rng(seed)
    if isinstance(gap_len, tuple):
        lo, hi = gap_len
        glens = np.exp(rng.uniform(np.log(lo), np.log(hi), G))
        glens = np.clip(np.round(glens).astype(np.int32), lo, hi)
        gap_len = int(hi)
    else:
        glens = np.full(G, gap_len, np.int32)
    span, gap_off = 2 * gap_len + 272, gap_len + 136
    L = G * span + 2 * flank_len
    truth = rng.integers(0, 4, L).astype(np.int8)
    gs = np.array([flank_len + g * span + gap_off for g in range(G)],
                  np.int32)
    ge = gs + glens

    recs = {k: [] for k in ("tid", "pos", "flag", "mapq", "mtid", "mpos",
                            "tlen", "lclip", "rclip")}
    names_lo, seqs = [], []
    margin = read_len - 8
    for g in range(G):
        for a in range(gs[g] - margin, ge[g] + margin - read_len + 1, step):
            b = a + read_len
            seqs.append(truth[a:b])
            # soft-clipped at the nearer gap edge, anchored outside
            if a < gs[g]:
                pos, lc, rc = a, 0, max(b - gs[g], 1)
            else:
                pos, lc, rc = ge[g], max(ge[g] - a, 1), 0
            for key, v in (("tid", 0), ("pos", pos), ("flag", 0x41),
                           ("mapq", 60), ("mtid", 0), ("mpos", pos),
                           ("tlen", 300), ("lclip", lc), ("rclip", rc)):
                recs[key].append(v)
            names_lo.append(len(names_lo))
    n_rec = len(seqs)
    B = -(-n_rec // n_shards) * n_shards
    pad = B - n_rec
    for k in recs:
        fill = -2 if k in ("tid", "mtid") else 0
        recs[k] = np.asarray(recs[k] + [fill] * pad, np.int32)
    name_hi = np.asarray([0] * n_rec + [0xFFFFFFFF] * pad, np.uint32)
    name_lo = np.asarray(names_lo + [0xFFFFFFFF] * pad, np.uint32)

    reads_tbl = np.full((n_rec, read_len), dna.N, np.int8)
    for i, s in enumerate(seqs):
        reads_tbl[i] = s
    reads_len = np.full(n_rec, read_len, np.int32)
    tbl_hi = np.zeros(n_rec, np.uint32)
    tbl_lo = np.arange(n_rec, dtype=np.uint32)
    tbl_row = np.arange(n_rec, dtype=np.int32)
    tbl_side = np.zeros(n_rec, np.int32)

    win = build_gap_windows(torch.zeros(G, dtype=torch.int32),
                            torch.from_numpy(gs), torch.from_numpy(ge),
                            dist2=390, clip_dist=250)
    wtid, wstart, wend, wgap, wedge = (
        r.numpy() for r in sort_windows(win["tid"], win["start"], win["end"],
                                        win["gap"], win["edge"]))

    flank_l = np.zeros((G, flank_len), np.int8)
    flank_r = np.zeros((G, flank_len), np.int8)
    for g in range(G):
        flank_l[g] = truth[gs[g] - flank_len:gs[g]]
        flank_r[g] = truth[ge[g]:ge[g] + flank_len]
    flank_ll = np.full(G, flank_len, np.int32)
    flank_rl = np.full(G, flank_len, np.int32)

    reads_per_gap_actual = (margin * 2 + gap_len - read_len) // step + 1
    region = 2 * margin + gap_len
    kmax = max(k for k, _ in kset)
    dims = SliceDims(
        n_shards=n_shards, n_gaps=G, gaps_per_shard=gaps_per_shard,
        entry_cap=max(64, 4 * gaps_per_shard * reads_per_gap_actual),
        reads_per_gap=1 << (reads_per_gap_actual - 1).bit_length(),
        kset=tuple(kset),
        max_distinct=1 << region.bit_length(),
        max_contig_len=1 << (gap_len + 2 * margin).bit_length(),
        # DBG caps from the expected distinct count (2 strands of a
        # contiguous region); check_overflow guards undersizing
        node_cap=1 << (2 * region + 4 * kmax).bit_length())

    args = (recs["tid"], recs["pos"], recs["flag"], recs["mapq"],
            recs["mtid"], recs["mpos"], recs["tlen"], recs["lclip"],
            recs["rclip"], name_hi, name_lo,
            wtid, wstart, wend, wgap, wedge, gs, ge,
            tbl_hi, tbl_lo, tbl_row, tbl_side,
            reads_tbl, reads_len, flank_l, flank_r, flank_ll, flank_rl)
    return dims, args


# gap-home ownership: gap g lives on shard g % N at local slot g // N
def home_of(gap: np.ndarray, n_shards: int):
    return gap % n_shards, gap // n_shards


def place_args(mesh, args):
    """Each of the 28 inputs placed with the step's sharding: this
    process's shards' pieces, on their devices (every process passes
    the same global values)."""
    return tuple(place(a, Sharding(mesh, s)) for a, s in zip(args, IN_SPECS))


def example_reads(args, rowtab):
    """What Collect would hand the Assembly and Pick stages for the
    scenario of `example_data`: its read store as one library's
    ReadSet, each gap's recruits (the rows of `rowtab`, the step's
    per-gap read table) as per_gap lists of (lib, side, row), and the
    gaps' flanks. Returns (readsets, per_gap, gaps)."""
    reads_tbl, reads_len = np.asarray(args[22]), np.asarray(args[23])
    n = len(reads_len)
    rs = ReadSet(seq=reads_tbl, length=reads_len,
                 qual=np.full(reads_tbl.shape, ord("I"), np.uint8),
                 name_hash=np.arange(n, dtype=np.uint64),
                 names=[b"r%d" % i for i in range(n)])
    per_gap = [[(0, 0, int(r)) for r in row if r >= 0]
               for row in np.asarray(rowtab)]
    gaps = {"start": np.asarray(args[16]), "end": np.asarray(args[17]),
            "flank_left": np.asarray(args[24]),
            "flank_right": np.asarray(args[25])}
    return [(rs, rs)], per_gap, gaps


def example_fills(args, per_gap, step: int = 4):
    """The planted bases of each gap of `example_data`'s scenario,
    recovered from the reads alone: gap g's reads, in row order, tile
    the truth at `step` from gap_start - margin (margin = read length
    - 8). Returns one int8 array of gap_end - gap_start codes a gap."""
    reads_tbl = np.asarray(args[22])
    margin = reads_tbl.shape[1] - 8
    fills = []
    for g, rows in enumerate(per_gap):
        glen = int(args[17][g]) - int(args[16][g])
        region = np.full(2 * margin + glen, dna.N, np.int8)
        for i, (_lib, _side, row) in enumerate(sorted(rows)):
            a = i * step
            n = min(reads_tbl.shape[1], len(region) - a)
            region[a:a + n] = reads_tbl[row, :n]
        fills.append(region[margin:margin + glen])
    return fills
