"""Assembly stage: per-gap multi-k de-Bruijn assembly (counterpart of
gappadder_tpu/pipeline/assemble.py).

Two things live here. The distinct-k-mer count path that the fused
batch (pipeline/fused.py) and the step share: `_merge_chunk(_impl)`,
`_merge_chunk_nocnt(_impl)`, `filter_min_count`. And the non-fused
Assembly batch (`tpu.fused=False`, the JAX package's host-glued
oracle path): `gap_distinct_kmers`, `count_gap_kmers` and
`assemble_gap_batch`, which for each unique k count each gap's
distinct canonical k-mers on the device, bring them to the host, and
for each (k, sub_k) assemble the k-mers themselves with the batched
DBG (ops/dbg.py), growing each cap on the host as the JAX package does.
Both device calls split the batch's gaps over the shards of a mesh
(`mesh.map_blocks`; without one, the one shard of
`mesh.local_mesh(device)`) and gather the results: every gap is
computed on its own, so the results and the caps grown from them are
the one-device ones.

Each gap's table of distinct canonical k-mers is merged chunk by chunk
with the k-mers of the next reads: concatenate, sort, keep the first of
every run, compact the survivors to the front with a cumsum-rank
scatter and cut back to the table width M. When more than M distinct
k-mers exist, the lexicographically largest fall off the end — the
saturation behaviour the caller detects through n == M.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from .. import dna, entry_device
from ..config import Config
from ..ops import dbg, kmers, psort
from ..parallel import mesh as pmesh
from ..utils import log
from ..utils.meters import span

FULL = 0xFFFFFFFF
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


def filter_min_count(acc, cnt, min_count: int):
    """Apply the min_kmer_count policy to a merged table: 0 keeps
    everything, -1 is the adaptive error filter, >1 a fixed cutoff.
    Returns (acc, cnt, distinct) with survivors re-compacted.

    The adaptive filter takes float32 sums as the JAX code does. Both
    sums are exact while they stay below 2^24; above that, torch and
    XLA add in different orders, and the `>= 4` test can flip only when
    the mean lies within float32 rounding of 4."""
    distinct = ~torch.all(acc == FULL, dim=-1)
    if min_count == -1:
        counts = torch.where(distinct, cnt, torch.zeros_like(cnt))
        cf = counts.to(torch.float32)
        inst = torch.sum(cf, dim=-1)
        inst2 = torch.sum(cf * cf, dim=-1)
        mean_inst = inst2 / torch.clamp(inst, min=1.0)
        drop = (mean_inst >= 4)[:, None] & (cnt < 2)
        distinct = distinct & ~drop
    elif min_count > 1:
        distinct = distinct & (cnt >= min_count)
    else:
        return acc, cnt, distinct
    acc = torch.where(distinct[..., None], acc, torch.full_like(acc, FULL))
    cnt = torch.where(distinct, cnt, torch.zeros_like(cnt))
    acc, ex = kmers.sort_kmers(acc, [cnt])
    cnt = ex[0]
    return acc, cnt, ~torch.all(acc == FULL, dim=-1)


def _merge_chunk_impl(acc, acc_cnt, limbs_new, cnt_new):
    G, M, nl = acc.shape
    both = torch.cat([acc, limbs_new], dim=1)
    cnts = torch.cat([acc_cnt, cnt_new], dim=1)
    res = psort.bitonic_sort(tuple(both[..., l] for l in range(nl))
                             + (cnts.to(torch.int64),), num_keys=nl)
    s = torch.stack(res[:nl], dim=-1)
    scnt = res[nl]
    first = kmers.unique_mask(s)
    keep = first & ~torch.all(s == FULL, dim=-1)
    # segment sums of the counts of equal keys via prefix sums
    csum = torch.cumsum(scnt.to(torch.int64), dim=-1)
    P = s.shape[1]
    idx = torch.arange(P, device=s.device).expand(G, P)
    nxt = kmers._next_first(first)
    c0 = torch.cat([torch.zeros_like(csum[:, :1]), csum], dim=-1)
    seg = (torch.gather(c0, -1, nxt)
           - torch.gather(c0, -1, torch.where(first, idx,
                                              torch.zeros_like(idx))))
    seg = torch.where(keep, seg, torch.zeros_like(seg)).to(torch.int32)
    return (kmers.compact(s, keep, M, FULL),
            kmers.compact(seg, keep, M, 0))


def _chunk_limbs(chunk, clen, k: int):
    limbs, valid = kmers.extract_kmers(chunk, clen, k)    # [G, Rc, P, nl]
    limbs = kmers.canonicalize(limbs, k)
    limbs = torch.where(valid[..., None], limbs, torch.full_like(limbs, FULL))
    G = limbs.shape[0]
    return limbs.reshape(G, -1, limbs.shape[-1]), valid.reshape(G, -1)


def _merge_chunk(chunk, clen, acc, acc_cnt, k: int):
    flat, valid = _chunk_limbs(chunk, clen, k)
    return _merge_chunk_impl(acc, acc_cnt, flat, valid.to(torch.int32))


def _merge_chunk_nocnt_impl(acc, limbs_new):
    """Distinct-set merge without multiplicities (no count operand, no
    segment sums)."""
    G, M, nl = acc.shape
    both = torch.cat([acc, limbs_new], dim=1)
    res = psort.bitonic_sort(tuple(both[..., l] for l in range(nl)),
                             num_keys=nl)
    s = torch.stack(res, dim=-1)
    keep = kmers.unique_mask(s) & ~torch.all(s == FULL, dim=-1)
    return kmers.compact(s, keep, M, FULL)


def _merge_chunk_nocnt(chunk, clen, acc, k: int):
    flat, _ = _chunk_limbs(chunk, clen, k)
    return _merge_chunk_nocnt_impl(acc, flat)


def gap_distinct_kmers(reads, read_len, n_reads, k: int,
                       max_distinct: int, read_chunk: int = 512,
                       min_count: int = 0, device="cuda"):
    """Distinct canonical k-mers of each gap's read set, with counts,
    counted on `device` (the card unless the caller asks for "cpu").

    Args:
      reads: int8 [G, R, L] padded read codes.
      read_len: int32 [G, R].
      n_reads: int32 [G] valid rows.
      max_distinct: bound M on distinct k-mers per gap (overflow drops
        the lexicographically largest k-mers).
      min_count: 0 keeps everything (the reference's `kmc -ci0`,
        assemble_gaps.py:96-102); -1 = adaptive: when a gap's mean
        k-mer multiplicity is >= 4, singleton k-mers (mostly sequencing
        errors) are dropped; >1 a fixed cutoff.

    Returns numpy (kstrings int8 [G, M, k], n_kstrings int32 [G],
    kcounts int32 [G, M] multiplicities, saturated bool [G]).
    """
    device = entry_device(device, "gap_distinct_kmers")
    G, R, L = reads.shape
    if L < k:
        pad = np.full((G, R, k - L), dna.N, np.int8)
        reads = np.concatenate([np.asarray(reads), pad], axis=2)
        L = k
    with torch.no_grad():
        acc = torch.full((G, max_distinct, kmers.num_limbs(k)), FULL,
                         dtype=torch.int64, device=device)
        cnt = torch.zeros((G, max_distinct), dtype=torch.int32,
                          device=device)
        row_idx = torch.arange(R, device=device)
        reads_t = torch.from_numpy(np.ascontiguousarray(reads)).to(device)
        rlen_t = torch.from_numpy(np.asarray(read_len, np.int32)).to(device)
        nr_t = torch.from_numpy(np.asarray(n_reads, np.int32)).to(device)
        for lo in range(0, R, read_chunk):
            hi = min(lo + read_chunk, R)
            clen = torch.where(row_idx[lo:hi][None, :] < nr_t[:, None],
                               rlen_t[:, lo:hi],
                               torch.zeros_like(rlen_t[:, lo:hi]))
            acc, cnt = _merge_chunk(reads_t[:, lo:hi], clen, acc, cnt, k)
        acc, cnt, distinct = filter_min_count(acc, cnt, min_count)
        n = distinct.sum(-1).to(torch.int32).cpu().numpy()
        kstr = dbg.unpack_kmers_to_strings(acc, k).cpu().numpy()
        cnt = cnt.cpu().numpy()
    # capacity saturated => lexicographically-largest k-mers may have
    # been dropped by the merge; caller must grow and retry (or warn)
    return kstr, n, cnt, n >= max_distinct


def count_gap_kmers(cfg: Config, reads, read_len, n_reads, k: int,
                    max_distinct: int, device="cuda", mesh=None, sp=None):
    """Distinct-k-mer counting with auto-growing capacity.

    When ``cfg.max_distinct_kmers`` is 0 (the default: reference-parity
    unbounded, the reference's assemble_gaps.py:96-102 `kmc -ci0`), a
    saturated table is retried at double capacity until it fits or the
    memory backstop is hit, each retry counted on the span `sp`; a
    fixed positive config value keeps the given bound but WARNS
    whenever it truncates.
    """
    if mesh is None:
        mesh = pmesh.local_mesh(device)
    auto = cfg.max_distinct_kmers == 0
    md = max_distinct if auto else cfg.max_distinct_kmers
    while True:
        kstr, nk, kcnt, sat = pmesh.map_blocks(
            mesh, lambda r, rl, nr, device: gap_distinct_kmers(
                r, rl, nr, k, md, min_count=cfg.min_kmer_count,
                device=device), reads, read_len, n_reads)
        if not sat.any():
            return kstr, nk, kcnt
        if auto and md < MAX_AUTO_DISTINCT:
            log.warn_cap(
                "kmer_table_grow",
                "distinct k-mer table saturated at %d for %d gap(s); "
                "retrying at %d", md, int(sat.sum()), md * 2)
            md *= 2
            if sp is not None:
                sp.add(retries=1)
            continue
        log.warn_cap(
            "kmer_table_truncated",
            "distinct k-mer table CAP %d truncating %d gap(s) "
            "(k=%d): lexicographically-largest k-mers dropped — raise "
            "max_distinct_kmers or set it to 0 (auto)",
            md, int(sat.sum()), k)
        return kstr, nk, kcnt


def assemble_gap_batch(cfg: Config, reads, read_len, n_reads,
                       max_distinct: int = 1 << 14,
                       device="cuda", mesh=None) -> GapContigs:
    """Run all (k, sub_k) settings over one padded gap batch on `device`
    (the card unless the caller asks for "cpu"), or with `mesh` split
    over its shards (G a multiple of them) and gathered.

    Output bounds are provably sufficient by default: a unitig over M
    distinct k-mers is at most M+k bases, so ``max_contig_len`` auto =
    next_pow2(M+k) can never truncate; the per-setting unitig count
    auto-doubles on saturation. Fixed config values warn when they bite
    (the reference's Velvet output is unbounded).
    """
    device = entry_device(device, "assemble_gap_batch")
    if mesh is None:
        mesh = pmesh.local_mesh(device)
    with span("assembly.batch") as sp:
        G = reads.shape[0]
        sp.add(batches=1, gaps=int(np.count_nonzero(n_reads)))
        seqs, lens, counts, names = [], [], [], [[] for _ in range(G)]
        # distinct-k-mer tables depend only on k: count once per unique k,
        # not once per (k, sub_k) setting
        kmer_cache: dict = {}
        for (k, sub_k) in cfg.kmers:
            if k not in kmer_cache:
                kmer_cache[k] = count_gap_kmers(cfg, reads, read_len,
                                                n_reads, k, max_distinct,
                                                device, mesh, sp)
        for (k, sub_k) in cfg.kmers:
            kstr, nk, kcnt = kmer_cache[k]
            md = kstr.shape[1]
            if cfg.max_contig_len > 0:
                max_len = cfg.max_contig_len
            else:
                max_len = _next_pow2(md + k)
            mu = max(cfg.max_unitigs, 1)
            # DBG working-set caps from the OBSERVED distinct counts: start
            # near the contiguous-region estimate and grow on overflow
            nk_max = max(int(np.asarray(nk).max(initial=0)), 1)
            ncap = _next_pow2(2 * nk_max + 4 * k)
            worst = kstr.shape[1] * 2 * (k - sub_k + 1)

            def unitigs(ks, n, kc, device, mu, cap):
                on = [torch.from_numpy(np.ascontiguousarray(x)).to(device)
                      for x in (ks, n, kc)]
                with torch.no_grad():
                    res = dbg.assemble_unitigs(
                        *on, k=k, sub_k=sub_k, max_unitigs=mu, max_len=max_len,
                        min_len=cfg.min_contig_len,
                        pop_bubbles=cfg.bubble_pop_rounds, node_cap=cap,
                        edge_cap=cap)
                return tuple(x.cpu().numpy() for x in res)

            while True:
                useq, ulen, ucnt, n_nodes, n_edges = pmesh.map_blocks(
                    mesh, lambda ks, n, kc, device: unitigs(
                        ks, n, kc, device, mu, min(ncap, worst)),
                    kstr, nk, kcnt)
                over = max(int(n_nodes.max()), int(n_edges.max()))
                if over > min(ncap, worst) and ncap < worst:
                    log.warn_cap(
                        "dbg_node_cap_grow",
                        "DBG node/edge cap %d overflowed (%d distinct, "
                        "k=%d); retrying at %d", ncap, over, k, ncap * 2)
                    ncap *= 2
                    sp.add(retries=1)
                    continue
                if (ucnt >= mu).any() and mu < (1 << 14):
                    log.warn_cap(
                        "unitig_slots_grow",
                        "unitig slots saturated at %d for %d gap(s) "
                        "(k=%d); retrying at %d", mu, int((ucnt >= mu).sum()),
                        k, mu * 2)
                    mu *= 2
                    sp.add(retries=1)
                    continue
                break
            if cfg.max_contig_len > 0 and (ulen >= max_len).any():
                log.warn_cap(
                    "contig_len_truncated",
                    "max_contig_len=%d truncated %d unitig(s) (k=%d): set "
                    "max_contig_len=0 (auto) for unbounded output",
                    max_len, int((ulen >= max_len).sum()), k)
            seqs.append(useq)
            lens.append(ulen)
            counts.append(ucnt)
            for g in range(G):
                names[g] += [f"{k}_{sub_k}_{i}" for i in range(int(ucnt[g]))]

        # compact per gap: concatenate settings, packing valid contigs first
        C = max(sum(s.shape[1] for s in seqs), 1)
        Lmax = max((s.shape[2] for s in seqs), default=1)
        out_seq = np.full((G, C, Lmax), dna.N, np.int8)
        out_len = np.zeros((G, C), np.int32)
        out_cnt = np.zeros(G, np.int32)
        for g in range(G):
            c = 0
            for si in range(len(seqs)):
                n = int(counts[si][g])
                out_seq[g, c:c + n, :seqs[si].shape[2]] = seqs[si][g, :n]
                out_len[g, c:c + n] = lens[si][g, :n]
                c += n
            out_cnt[g] = c
        return GapContigs(seq=out_seq, length=out_len, count=out_cnt,
                          names=names)
