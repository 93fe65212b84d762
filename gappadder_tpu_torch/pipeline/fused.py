"""The shipped Assembly stage's device batch (counterpart of
gappadder_tpu/pipeline/fused.py::assemble_batch), on one device or over
the shards of a mesh.

One gap batch goes through the same blocks as the fused step
(parallel/slice.py): gap-home routing (`dist.route_shard`), per-gap
grouping (`slice._group_rows`), the payload gather and the
multi-(k, sub_k) DBG assembly (`slice._assemble_block`). They run
under `mesh.shard_map` as the JAX form runs under `shard_map`, over a
mesh of N shards or, without one, over the one shard of
`mesh.local_mesh(device)` (the card, or the CPU when the caller asks
for it): batch slot i lives on shard i % N at local slot i // N,
the entries are split over the shards and routed home, the compact
read store is replicated, and the capacity indicators are maxed over
the shards.

Caps grow as in the JAX package: after each run the step's overflow
indicators are read and the offending dimension is doubled (the
distinct-k-mer table, the DBG node cap, the unitig slots, the contig
length) until nothing truncates, each growth announced through
`log.warn_cap` under the JAX package's key.
"""

from __future__ import annotations

import dataclasses
import functools

import numpy as np
import torch

from .. import dna, entry_device
from ..config import Config
from ..parallel import dist, mp
from ..parallel.mesh import DP, REP, Sharding, local_mesh, place, shard_map
from ..parallel.slice import (SliceDims, _assemble_block, _group_rows,
                              gather_reads)
from ..utils import log
from ..utils.meters import span

# hard memory backstop for the auto-grown distinct-k-mer table
# ([G, M, nl] sort buffers): 4M k-mers per gap ~ a >4 Mb unitig
MAX_AUTO_DISTINCT = 1 << 22


@dataclasses.dataclass
class GapContigs:
    """Per-gap contig sets (padded arrays + names)."""
    seq: np.ndarray      # int8 [G, C, Lmax]
    length: np.ndarray   # int32 [G, C]
    count: np.ndarray    # int32 [G]
    names: list[list[str]]  # [G][C] contig names ("<k>_<sub_k>_<i>")


def _next_pow2(n: int) -> int:
    return 1 << max(int(n) - 1, 0).bit_length()


def _compact_store(batch, per_gap, readsets, R: int, L: int):
    """Per-batch compact read store: only the rows the batch's gaps
    reference are gathered. Returns (entries (gap_slot, store_row),
    reads_tbl [Np2, L], reads_len [Np2]) with Np2 a power of two."""
    keys: dict[tuple[int, int, int], int] = {}
    eg, er = [], []
    for i, g in enumerate(batch):
        if g < 0:
            continue
        rows = per_gap[g][:R] if R else per_gap[g]
        for key in rows:
            idx = keys.get(key)
            if idx is None:
                idx = keys[key] = len(keys)
            eg.append(i)
            er.append(idx)
    n = max(len(keys), 1)
    Np2 = 1 << (n - 1).bit_length()
    reads_tbl = np.full((Np2, L), dna.N, np.int8)
    reads_len = np.zeros(Np2, np.int32)
    for (li, side, row), idx in keys.items():
        rs = readsets[li][side]
        ln = min(int(rs.length[row]), L)
        reads_tbl[idx, :ln] = rs.get_seq(row)[:ln]
        reads_len[idx] = ln
    return eg, er, reads_tbl, reads_len


def _assemble_step(egap, erow, ehq, reads_tbl, reads_len, *,
                   dims: SliceDims, coll):
    """Blocks 2-3 of the fused step on one shard (`coll` its
    Collectives): route the entries to their gap-home shard, group them
    into [Gl, R] row tables, gather the reads, assemble. Returns (over
    int32 [7], maxed over the shards; meta int32 [Gl, 1 + C + S];
    useq)."""
    valid = egap >= 0
    # gap-home = slot % N
    dest = torch.where(valid, torch.remainder(egap, dims.n_shards),
                       torch.zeros_like(egap))
    (rgap, rrow, rhq), _src, n_recv = dist.route_shard(
        (egap, erow, ehq), dest, valid, out_cap=dims.entry_cap,
        fills=(-1, -1, -1), coll=coll)
    rowtab, _hqtab, n_reads, n_raw_max = _group_rows(
        rgap, rrow, rhq.to(torch.bool), rgap >= 0, dims)
    seq, rlen = gather_reads(rowtab, reads_tbl, reads_len)
    useq, ulen, ucnt, _hist, (o_nodes, o_edges, o_nk) = _assemble_block(
        seq, rlen, dims)
    i32 = torch.int32
    over = torch.stack([x.to(i32) for x in (
        o_nodes, o_edges, n_raw_max, o_nk, n_recv[0],
        torch.clamp(ucnt.max(), min=0), torch.clamp(ulen.max(), min=0))])
    over = coll.pmax(over)
    meta = torch.cat([n_reads[:, None].to(i32), ulen.to(i32),
                      ucnt.to(i32)], dim=1)
    return over, meta, useq


# entries split over the shards, the read store replicated
ASSEMBLE_IN_SPECS = (DP, DP, DP, REP, REP)


@functools.lru_cache(maxsize=64)
def make_assemble_step(mesh, dims: SliceDims):
    """`_assemble_step` over `mesh`, cached per (mesh, dims): entries
    split over the shards, the read store replicated; over replicated,
    meta and useq each shard's."""
    return shard_map(functools.partial(_assemble_step, dims=dims), mesh,
                     ASSEMBLE_IN_SPECS, (REP, DP, DP))


def assemble_batch(cfg: Config, batch, per_gap, readsets, R: int, L: int,
                   max_distinct: int, device="cuda",
                   mesh=None) -> GapContigs:
    """Assemble one gap batch on `device` (the card unless the caller
    asks for "cpu"), or with `mesh` over its shards (on their devices;
    len(batch) must be a multiple of the shards). Without a mesh the
    batch runs on `mesh.local_mesh(device)`, one shard.

    Args:
      batch: list of gap indices (may contain -1 padding slots).
      per_gap: global per-gap [(lib, side, row), ...] lists.
      readsets: [(left ReadSet, right ReadSet), ...] per library.
      R: reads-per-gap bucket.
      L: padded read length.
      max_distinct: starting distinct-k-mer bound for this bucket.

    Returns GapContigs for the batch (host arrays + names), equal to
    the JAX package's assemble_batch on the same read sets, whatever
    the mesh."""
    device = entry_device(device, "assemble_batch")
    if mesh is None:
        mesh = local_mesh(device)
    N = mesh.n_shards
    Gb = len(batch)
    if Gb % N:
        raise ValueError(f"assemble_batch: {Gb} gap slots do not split "
                         f"over {N} shards")
    Gl = Gb // N
    with span("assembly.batch") as sp:
        sp.add(batches=1, gaps=sum(g >= 0 for g in batch))
        # compact read store + dense entries: gap -> batch slot (slot i
        # lives on shard i % N at local slot i // N), row -> store
        eg, er, reads_tbl, reads_len = _compact_store(
            batch, per_gap, readsets, R, L)
        E = max(len(eg), N)
        E = 1 << (E - 1).bit_length()
        E = -(-E // N) * N
        egap = np.full(E, -1, np.int32)
        erow = np.zeros(E, np.int32)
        ehq = np.zeros(E, np.int32)
        egap[:len(eg)] = eg
        erow[:len(er)] = er
        inputs = [place(x, Sharding(mesh, s)) for x, s in zip(
            (egap, erow, ehq, reads_tbl, reads_len), ASSEMBLE_IN_SPECS)]

        kmax = max(k for k, _ in cfg.kmers)
        mu = max(cfg.max_unitigs, 1)
        md = (max_distinct if cfg.max_distinct_kmers == 0
              else cfg.max_distinct_kmers)
        auto_md = cfg.max_distinct_kmers == 0
        ncap_override = 0          # 0 = SliceDims auto formula
        Lc_override = 0            # 0 = auto (tight start, grow on demand)
        warned_trunc = False
        while True:
            if cfg.max_contig_len > 0:
                Lc = cfg.max_contig_len
            else:
                # tight start: unitigs are usually region-sized, far below
                # the md + k worst case; the o_ulen indicator grows the cap
                Lc = max(512, _next_pow2(md // 4 + kmax), Lc_override)
            dims = SliceDims(
                n_shards=N, n_gaps=Gb, gaps_per_shard=Gl, entry_cap=E,
                reads_per_gap=max(R, 1), kset=tuple(cfg.kmers),
                max_distinct=md, node_cap=ncap_override,
                max_unitigs=mu, max_contig_len=Lc,
                min_contig_len=cfg.min_contig_len,
                min_kmer_count=cfg.min_kmer_count,
                pop_bubbles=cfg.bubble_pop_rounds,
                fixed_kmer_cap=cfg.max_distinct_kmers != 0)
            over, meta, useq = make_assemble_step(mesh, dims)(*inputs)
            o_nodes, o_edges, _nraw, o_nk, _nrecv, o_ucnt, o_ulen = (
                int(x) for x in mp.to_np(over))
            if o_nk >= md:
                if auto_md and md < MAX_AUTO_DISTINCT:
                    log.warn_cap(
                        "kmer_table_grow",
                        "fused: distinct k-mer table saturated at %d; "
                        "retrying at %d", md, md * 2)
                    md *= 2
                    ncap_override = 0
                    sp.add(retries=1)
                    continue
                if not warned_trunc:
                    warned_trunc = True
                    log.warn_cap(
                        "kmer_table_truncated",
                        "distinct k-mer table CAP %d truncating "
                        "(lexicographically-largest k-mers dropped) — raise "
                        "max_distinct_kmers or set it to 0 (auto)", md)
            ncap = (ncap_override or
                    min(dims.effective_node_cap(k) for k, _ in cfg.kmers))
            if max(o_nodes, o_edges) > ncap:
                grown = 1 << max(o_nodes, o_edges).bit_length()
                log.warn_cap("dbg_node_cap_grow",
                             "fused: DBG node/edge cap %d overflowed (%d); "
                             "retrying at %d", ncap, max(o_nodes, o_edges),
                             grown)
                ncap_override = grown
                sp.add(retries=1)
                continue
            if o_ucnt >= mu and mu < (1 << 14):
                log.warn_cap("unitig_slots_grow",
                             "fused: unitig slots saturated at %d; retrying "
                             "at %d", mu, mu * 2)
                mu *= 2
                sp.add(retries=1)
                continue
            if o_ulen >= Lc:
                if cfg.max_contig_len > 0:
                    log.warn_cap(
                        "contig_len_truncated",
                        "max_contig_len=%d truncated unitig(s): set "
                        "max_contig_len=0 (auto) for unbounded output", Lc)
                else:
                    log.warn_cap(
                        "contig_len_grow",
                        "fused: contig-length cap %d saturated; retrying at "
                        "%d", Lc, Lc * 2)
                    Lc_override = Lc * 2
                    sp.add(retries=1)
                    continue
            break

        # ---- reassemble the batch order + compact + name ---------------
        meta = mp.to_np(meta)
        useq = mp.to_np(useq)
        S = len(cfg.kmers)
        C = S * mu
        ulen = meta[:, 1:1 + C]
        ucnt = meta[:, 1 + C:1 + C + S]     # [Gb, S] per-setting counts
        out_seq = np.full((Gb, C, useq.shape[2]), dna.N, np.int8)
        out_len = np.zeros((Gb, C), np.int32)
        out_cnt = np.zeros(Gb, np.int32)
        names: list[list[str]] = [[] for _ in range(Gb)]
        for i in range(Gb):
            # batch slot i lives on shard i % N, local slot i // N; the
            # per-shard outputs are shard-major: row (i % N) * Gl + i // N
            r = (i % N) * Gl + i // N
            c = 0
            for si, (k, sub_k) in enumerate(cfg.kmers):
                n = int(ucnt[r, si])
                blk = slice(si * mu, si * mu + n)
                out_seq[i, c:c + n] = useq[r, blk]
                out_len[i, c:c + n] = ulen[r, blk]
                names[i] += [f"{k}_{sub_k}_{j}" for j in range(n)]
                c += n
            out_cnt[i] = c
        return GapContigs(seq=out_seq, length=out_len, count=out_cnt,
                          names=names)
