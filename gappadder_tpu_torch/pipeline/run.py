"""Assembly+Pick driver: the full two-round pipeline with rescue
(counterpart of gappadder_tpu/pipeline/run.py), on one device or with
the Assembly batches over the shards of a mesh.

  round 1: per-gap multi-k DBG assembly (the fused device batch) ->
           dedup/merge -> full pick (bwa-score threshold 30);
  rescue:  both-ends-unmapped pairs matched against open gaps' contigs
           join those gaps' read sets (pipeline/rescue.py);
  round 2: re-assemble rescued gaps -> merge -> pick(30);
  final:   HQ clip-read pseudo-contigs appended + re-merge, then the
           relaxed full pick (threshold 15) and the extension fallback.

The three parts run inside the spans `assembly.round1`, `.round2` and
`.final`; each counts the `gaps` it works on and the fills it adds
(`filled`), round 2 also the gaps rescue gave reads (`rescued`), final
also the gaps HQ gave pseudo-contigs (`hq_gaps`) and the extensions
(`extended`).

Every device stage (the Assembly batches, the dedup and overlap SW
screens, the Evaluate DP, the seed index and join, the rescue SW, the
pick passes) runs on `device`: the card unless the caller asks for
"cpu". The host code between them is the JAX package's, so the outputs
(`picked_seqs.fa`, `picked_seqs.fa_ori.txt`, `merge_info.txt`, the
fills, extensions and contig store) are the JAX package's, byte for
byte. A configured `tpu.mesh_shape` shards the Assembly batches over a
mesh when the processes hold that many shards
(`mesh.make_mesh_if_configured`), and runs unsharded otherwise (one
shard, `mesh.local_mesh(device)`), as the JAX
package does with fewer devices than the mesh; the outputs are the same
either way. The host stages (merge, pick, rescue) compute the same
bytes on every process, and only process 0 writes files. Gap batches
are bucketed by read count so padded shapes stay few.
"""

from __future__ import annotations

import numpy as np

from .. import dna, entry_device
from ..config import Config
from ..io import fasta, fastq
from ..ops import merge_engine
from ..parallel.mesh import local_mesh, make_mesh_if_configured
from ..utils import log
from ..utils.meters import span, spanned
from . import fused, pick, rescue
from .preprocess import gap_ids
from .workspace import Workspace, config_hash

MERGE_SKIP_BASES = 1 << 20   # MergeContigs.py:79-83 skips merging >1MB sets


@spanned("assembly.refine")
def refine_contigs_multi(items, mcfg: merge_engine.MergeConfig,
                         device="cuda"):
    """Batched per-gap dedup -> overlap merge -> dedup
    (MergeContigs.py:15-99) over many gaps at once.

    items: list of (contig list, name list) per gap. Returns a list of
    (contigs, names, merge_info_lines) — identical per gap to
    refine_contigs, but every stage's device work (dedup SW screens,
    the merge overlap screen, the exact Evaluate DP, path splicing) is
    batched ACROSS gaps: a whole gap batch costs a handful of device
    batches instead of O(gaps * pairs)."""
    keeps = merge_engine.dedup_contigs_multi([c for c, _ in items], mcfg,
                                             device=device)
    clists = [[cl[i] for i in k] for (cl, _), k in zip(items, keeps)]
    nameses = [[nm[i] for i in k] for (_, nm), k in zip(items, keeps)]
    # merge-info per gap: None = merge step did NOT run (size guard /
    # no contigs); [] = ran and merged nothing — callers must then
    # CLEAR stale provenance, like the binary rewriting its (possibly
    # empty) -o file on every run
    minfo: list[list[str] | None] = [None for _ in items]
    merge_idx = [i for i, cl in enumerate(clists)
                 if cl and sum(len(c) for c in cl) <= MERGE_SKIP_BASES]
    if merge_idx:
        res = merge_engine.merge_contigs_multi(
            [clists[i] for i in merge_idx], mcfg, device=device)
        redo = []
        for i, (merged, infos) in zip(merge_idx, res):
            minfo[i] = []
            if merged:
                minfo[i] = merge_engine.merge_info_lines(nameses[i], infos)
                clists[i] = clists[i] + merged
                nameses[i] = nameses[i] + [
                    # 1-based: the binary's `static int contigNumNext=1`
                    # (ContigsCompactor.cpp:929-960)
                    f"NEW_CONTIG_MERGE_{j + 1}" for j in
                    range(len(merged))]
                redo.append(i)
        if redo:
            keeps2 = merge_engine.dedup_contigs_multi(
                [clists[i] for i in redo], mcfg, device=device)
            for i, k in zip(redo, keeps2):
                clists[i] = [clists[i][j] for j in k]
                nameses[i] = [nameses[i][j] for j in k]
    return list(zip(clists, nameses, minfo))


def refine_contigs(clist, names, mcfg: merge_engine.MergeConfig,
                   device="cuda"):
    """Per-gap dedup -> overlap merge -> dedup (MergeContigs.py:15-99).

    Returns (contigs, names, merge_info_lines): the third element is
    the reference ContigsMerger's .merge.info provenance (which source
    contigs, in path order, formed each NEW_CONTIG_MERGE_*; recorded
    BEFORE the post-merge dedup, like the binary writes its -o file)."""
    return refine_contigs_multi([(clist, names)], mcfg, device)[0]


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
    return fused.GapContigs(seq=seq, length=lens, count=cnt, names=names)


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


# keep G*R (padded read rows resident per assembly batch) bounded so
# huge gaps shrink the gap batch instead of blowing device memory
_MAX_BATCH_ROWS = 1 << 21


def _bucket_of(n: int):
    """(reads bucket R, distinct-kmer start bound) for an n-read gap."""
    for r, md in _BUCKETS:
        if n <= r:
            return r, md
    R = 1 << max(n - 1, 1).bit_length()
    return R, 2 * R


def _assemble_gaps(cfg, gap_list, per_gap, readsets, L, contig_store, mcfg,
                   minfo=None, device="cuda", mesh=None):
    """Assemble + refine contigs for the given gaps (bucketed by read
    count), through the fused device batch (`fused.assemble_batch`) over
    `mesh` (default: the one shard of `mesh.local_mesh(device)`): the
    gap batch is a multiple of its shards and split over them (per-gap
    assembly needs no collective but the route home)."""
    if mesh is None:
        mesh = local_mesh(device)
    buckets: dict[int, list[int]] = {}
    md_of = dict(_BUCKETS)
    cap = cfg.max_reads_per_gap
    for g in gap_list:
        n = max(len(per_gap[g]), 1)
        if cap and n > cap:
            log.warn_cap(
                "reads_per_gap_truncated",
                "max_reads_per_gap=%d truncating a %d-read gap; set "
                "max_reads_per_gap=0 (default) for unbounded recruit "
                "sets", cap, n)
            n = cap
        R, md = _bucket_of(n)
        md_of[R] = md
        buckets.setdefault(R, []).append(g)
    raw_store: dict[int, tuple] = {}
    raw_order: list[int] = []
    GB = max(int(getattr(cfg.tpu, "gap_batch", 16)), 1)
    m = mesh.n_shards
    GB = -(-GB // m) * m
    for R, gl in sorted(buckets.items()):
        gb = GB
        if R * GB > _MAX_BATCH_ROWS:
            gb = max(-(-max(_MAX_BATCH_ROWS // R, 1) // m) * m, m)
        for lo in range(0, len(gl), gb):
            batch = gl[lo:lo + gb]
            padded = batch + [-1] * (gb - len(batch))  # fixed G shape
            Rcap = min(R, cap) if cap else R
            contigs = fused.assemble_batch(
                cfg, padded, per_gap, readsets, Rcap, L,
                max_distinct=md_of[R], device=device, mesh=mesh)
            for i, g in enumerate(batch):
                raw_order.append(g)
                raw_store[g] = ([np.asarray(contigs.seq[i][j]
                                            [:int(contigs.length[i][j])])
                                 for j in range(int(contigs.count[i]))],
                                contigs.names[i])

    # cross-gap batched refine over EVERYTHING just assembled: the dedup
    # SW screens, merge overlap screen, exact Evaluate DP and path
    # splicing each run as a handful of device batches for the WHOLE
    # gap list instead of per-gap (or per-batch) chains
    items = [raw_store[g] for g in raw_order]
    for g, (clist, cnames, ilines) in zip(
            raw_order, refine_contigs_multi(items, mcfg, device)
            if items else []):
        if minfo is not None and ilines is not None:
            if ilines:
                minfo[g] = ilines
            else:
                minfo.pop(g, None)   # merger ran, merged nothing: the
                #                      reference rewrites its -o empty
        contig_store[g] = _tuple_from_list(clist, cnames)


def _pick_gaps(cfg, gaps, gap_list, contig_store, fills, exts, min_score,
               allow_extension, device="cuda"):
    """Pick the gaps of `gap_list` that have contigs and no fill yet, in
    batches of 64: full closures into `fills[g] = (seq, contig name)`,
    and with `allow_extension` the extension fallback into `exts`. The
    SW passes and the winners' tracebacks run on `device` (the card
    unless the caller asks for "cpu"); the `assembly.pick` span counts
    the `tracebacks`, their `cells` and the traceback kernel's
    `launches`."""
    with span("assembly.pick") as sp:
        gap_list = [g for g in gap_list if g in contig_store
                    and contig_store[g][2] > 0 and g not in fills]
        # 64-gap pick batches: each batch is up to max_hits local passes
        # and one fit pass, each with one traceback call for its winners
        for lo in range(0, len(gap_list), 64):
            batch = gap_list[lo:lo + 64]
            gc = _restack(contig_store, batch)
            fl = gaps["flank_left"][batch]
            fr = gaps["flank_right"][batch]
            hits = pick.align_flanks_to_contigs(
                fl, fr, gc.seq, gc.length, gc.count,
                min_score=min_score, max_hits=cfg.pick_max_hits,
                device=device, meter=sp)
            for i, g in enumerate(batch):
                res = pick.pick_full(hits[i], gc.seq[i], gc.length[i])
                if res is not None:
                    c, gap_seq, rc, _ = res
                    fills[g] = (gap_seq, gc.names[i][c])
                elif allow_extension and g not in exts:
                    res = pick.pick_extension(hits[i], gc.seq[i],
                                              gc.length[i])
                    if res is not None:
                        lc, rc_, seq, _ = res
                        nm = gc.names[i]
                        lname = nm[lc] if lc >= 0 else ""
                        rname = nm[rc_] if rc_ >= 0 else ""
                        # keep the exact winner names alongside the
                        # joined display string (contig names embed
                        # underscores, so the joined form is not
                        # splittable)
                        exts[g] = (seq, f"{lname}_{rname}", (lname, rname))


def run_assembly_and_pick(cfg: Config, ws: Workspace, rec=None,
                          readsets=None, genome: fasta.Genome | None = None,
                          device="cuda"):
    """Returns (fills, exts, contig_store); writes picked_seqs.fa,
    picked_seqs.fa_ori.txt and merge_info.txt into the workspace. Every
    device stage runs on `device` (the card unless the caller asks for
    "cpu"); raises without a card otherwise."""
    device = entry_device(device, "run_assembly_and_pick")
    gaps = ws.load_arrays("gaps")
    n_gaps = len(gaps["start"])
    if rec is None:
        z = ws.load_arrays("recruits")
        rec = {k: z[k] for k in z}
    if readsets is None:
        readsets = []
        for lib in cfg.libraries:
            readsets.append((
                fastq.scan_fastq(lib.left_fq) if lib.left_fq else None,
                fastq.scan_fastq(lib.right_fq) if lib.right_fq else None))

    per_gap = build_gap_read_arrays(rec, readsets, n_gaps)
    active = [g for g in range(n_gaps) if per_gap[g]]
    fills: dict[int, tuple] = {}
    exts: dict[int, tuple] = {}
    contig_store: dict[int, tuple] = {}
    if not active:
        _write_picked(cfg, ws, gaps, fills, exts)
        ws.mark_done("assembly", config_hash(cfg), filled=0, extended=0)
        return fills, exts, contig_store

    max_read_len = max(
        (int(rs.length.max()) if rs is not None and rs.n else 0)
        for pair in readsets for rs in pair)
    L = max(max_read_len, max(k for k, _ in cfg.kmers) + 1, 1)

    mcfg = merge_engine.MergeConfig(
        frac_score_loss=cfg.merge_max_frac_score_loss,
        min_overlap_len=cfg.merge_min_overlap_len,
        max_clip_len=cfg.merge_max_clip_len,
        kmer_len=cfg.merge_kmer_len,
        min_support_kmer=cfg.merge_min_support_kmer,
        dedup_cutoff=cfg.dedup_cutoff)

    # merge provenance: gap -> reference-format .merge.info lines
    minfo: dict[int, list[str]] = {}
    mesh = make_mesh_if_configured(cfg, device)

    # each round's span counts the gaps it works on and the fills it adds
    # ---- round 1 --------------------------------------------------------
    with span("assembly.round1") as s:
        _assemble_gaps(cfg, active, per_gap, readsets, L, contig_store,
                       mcfg, minfo=minfo, device=device, mesh=mesh)
        _pick_gaps(cfg, gaps, active, contig_store, fills, exts,
                   cfg.pick_min_score_round1, allow_extension=False,
                   device=device)
        s.add(gaps=len(active), filled=len(fills))

    # ---- rescue + round 2 ----------------------------------------------
    open_gaps = [g for g in active if g not in fills]
    with span("assembly.round2") as s:
        filled, round2 = len(fills), []
        if open_gaps:
            extra = rescue.rescue_both_unmapped(cfg, ws, readsets,
                                                contig_store, open_gaps,
                                                device=device)
            round2 = [g for g in open_gaps if extra.get(g)]
            for g in round2:
                seen = set(per_gap[g])
                per_gap[g] += [e for e in extra[g] if e not in seen]
            if round2:
                _assemble_gaps(cfg, round2, per_gap, readsets, L,
                               contig_store, mcfg, minfo=minfo,
                               device=device, mesh=mesh)
                _pick_gaps(cfg, gaps, round2, contig_store, fills, exts,
                           cfg.pick_min_score_round1,
                           allow_extension=False, device=device)
        s.add(gaps=len(open_gaps), rescued=len(round2),
              filled=len(fills) - filled)

    # ---- HQ clip pseudo-contigs + final relaxed pick --------------------
    open_gaps = [g for g in active if g not in fills]
    with span("assembly.final") as s:
        filled = len(fills)
        hq_per_gap: dict[int, list] = {}
        for g, side, li, row, hq in zip(rec["gap"], rec["side"],
                                        rec["lib"], rec["row"], rec["hq"]):
            if hq and int(g) in set(open_gaps):
                hq_per_gap.setdefault(int(g), []).append(
                    (int(li), int(side), int(row)))
        hq_gaps, hq_items = [], []
        for g in open_gaps:
            if g not in contig_store:
                continue
            pseudo = rescue.hq_pseudo_contigs(cfg, g, contig_store,
                                              readsets,
                                              hq_per_gap.get(g, []),
                                              device=device)
            if not pseudo:
                continue
            cs, cl, n, nm = contig_store[g]
            clist = [np.asarray(cs[i][:int(cl[i])]) for i in range(n)] + \
                pseudo
            names = nm + [f"hqread_{i}" for i in range(len(pseudo))]
            hq_gaps.append(g)
            hq_items.append((clist, names))
        for g, (clist, names, ilines) in zip(
                hq_gaps, refine_contigs_multi(hq_items, mcfg, device)
                if hq_items else []):
            if ilines is not None:
                if ilines:
                    minfo[g] = ilines    # last merge run wins, like the
                    #                      binary overwriting its -o file
                else:
                    minfo.pop(g, None)
            contig_store[g] = _tuple_from_list(clist, names)
        _pick_gaps(cfg, gaps, open_gaps, contig_store, fills, exts,
                   cfg.pick_min_score_final, allow_extension=True,
                   device=device)
        s.add(gaps=len(open_gaps), filled=len(fills) - filled,
              hq_gaps=len(hq_gaps), extended=len(exts))

    _write_picked(cfg, ws, gaps, fills, exts, contig_store)
    _write_merge_info(ws, gaps, minfo)
    ws.mark_done("assembly", config_hash(cfg), filled=len(fills),
                 extended=len(exts))
    return fills, exts, contig_store


def _write_merge_info(ws, gaps, minfo):
    """merge_info.txt: per-gap ContigsMerger .merge.info provenance
    ('<gap_id>\\tNEW_CONTIG_MERGE_<i>  <member contig names>'), the
    consolidated equivalent of the reference's per-gap -o files
    (MergeContigs.py:85-88 '-o {f}.merge.info';
    ContigsCompactor.cpp:1545-1563)."""
    from ..parallel import mp
    if not mp.is_primary():
        return
    ids = gap_ids(gaps)
    with open(ws.path("merge_info.txt"), "w") as fh:
        for g in sorted(minfo):
            for line in minfo[g]:
                fh.write(f"{ids[g]}\t{line}\n")


def _write_picked(cfg, ws, gaps, fills, exts, contig_store=None):
    """picked_seqs.fa in the reference's naming
    (<gap_id>_<contig> / <gap_id>_<l>_<r>_extended), plus
    picked_seqs.fa_ori.txt with the WHOLE winning contigs
    (pick_contigs.py:566-572 cats per-gap picked_contigs.fa there)."""
    from ..parallel import mp
    if not mp.is_primary():
        return
    ids = gap_ids(gaps)
    recs = []
    for g, (seq, cname) in sorted(fills.items()):
        recs.append((f"{ids[g]}_{cname}", seq))
    for g, ext in sorted(exts.items()):
        if g in fills:
            continue
        recs.append((f"{ids[g]}_{ext[1]}_extended", ext[0]))
    fasta.write_fasta(ws.path("picked_seqs.fa"), recs)

    if contig_store is None:
        return
    ori = []
    for g in sorted(set(fills) | set(exts)):
        if g not in contig_store:
            continue
        s, l, n, names = contig_store[g]
        if g in fills:
            wanted = {fills[g][1]}
        else:
            wanted = {nm for nm in exts[g][2] if nm}
        for i in range(int(n)):
            if names[i] in wanted:
                ori.append((f"{ids[g]}_{names[i]}",
                            np.asarray(s[i][:int(l[i])])))
    fasta.write_fasta(ws.path("picked_seqs.fa_ori.txt"), ori)


def fills_as_codes(fills: dict[int, tuple]) -> dict[int, np.ndarray]:
    return {g: seq for g, (seq, _name) in fills.items()}
