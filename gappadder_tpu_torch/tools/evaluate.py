"""Evaluation against a finished genome (counterpart of
gappadder_tpu/tools/evaluate.py; the reference's golden-truth scripts
gnrt_gap_seqs, statistic_rslt.py and discordant_alignment_statistic.py).

Given a FINISHED genome for the same organism, extract each gap's
"true" sequence by locating the gap flanks in the finished assembly
(gnrt_pos_true_seqs.py:120-188), then score closures: a picked fill
counts as CLOSED when it aligns to the truth without >= 20 bp clipping
on either side (statistic_rslt.py:80-127 -> hit_list.txt,
closed_gap_length.txt).

Every alignment runs through the SW kernel on `device` (the card unless
the caller asks for "cpu"): batches through `swutil.sw_pairs` /
`sw_ragged`, lone pairs through `swutil.sw_small`, unpadded to the
buckets. The tracebacks are the host's (`sw_host.alignment_stats`), as
in the JAX package, so the results are the JAX package's exactly.
"""

from __future__ import annotations

import numpy as np

from .. import dna, entry_device
from ..io import fasta
from ..ops import swutil
from ..ops.sw_host import BWA_PARAMS, SWParams, alignment_stats

CLIP_CUTOFF = 20     # statistic_rslt.py is_qualified_clipped cutoff
FLANK_CLIP_CUTOFF = 10  # gnrt_gap_seqs uses 10 for flank placement


def _best_placement(query: np.ndarray, genome: fasta.Genome, device="cuda"):
    """Best local alignment of query against every scaffold (both
    strands). Returns (scaf, strand, tstart, tend, qstart, qend,
    score) or None. O(|genome| x |query|): only used as the fallback
    for queries the seeded path cannot anchor (and for tiny genomes);
    the production path is seeded_placements below."""
    device = entry_device(device, "_best_placement")
    best = None
    for si in range(genome.num_scaffolds):
        t = genome.scaffold(si)
        if len(t) == 0:
            continue
        for strand, q in ((0, query), (1, dna.revcomp(query))):
            s, qe, te = swutil.sw_small([q], [t], BWA_PARAMS, "local",
                                        device=device)
            sc = int(s[0])
            if best is None or sc > best[6]:
                qe, te = int(qe[0]), int(te[0])
                # the path ending at (qe, te) reads only the DP cells
                # up to that row and column: the same traceback on the
                # prefixes, without a matrix over the whole scaffold
                qs, ts, _ = alignment_stats(q[:qe], t[:te], BWA_PARAMS,
                                            "local", qe, te)
                best = (si, strand, ts, te, qs, qe, sc)
    return best


# full-DP fallback is affordable below this finished-genome size
_FALLBACK_GENOME_LIMIT = 1 << 20
_SEED_PAD = 64


def seeded_placements(queries, genome: fasta.Genome, index=None,
                      device="cuda"):
    """Scalable batched placement: minimizer seeding locates each
    query's window (ops/minimap.py), then one batched local DP over the
    padded windows — O(|query| x window) instead of the full-genome DP
    the reference effectively runs (statistic_rslt.py:8-25 shells one
    `bwa mem` per gap; _best_placement above is the literal-DP analog).

    queries: list of code arrays. Returns list of placement tuples
    (scaf, strand, tstart, tend, qstart, qend, score) or None, same
    semantics as _best_placement.
    """
    from ..ops import minimap

    device = entry_device(device, "seeded_placements")
    if index is None:
        index = minimap.build_index(genome)
    n = len(queries)
    out = [None] * n
    if n == 0:
        return out
    Lmax = max(max(len(q) for q in queries), 8)
    qa = np.full((n, Lmax), dna.N, np.int8)
    ql = np.zeros(n, np.int32)
    for i, q in enumerate(queries):
        qa[i, :len(q)] = q
        ql[i] = len(q)
    pl = minimap.map_reads(genome, index, qa, ql, min_score=20)

    idx_hit = [i for i in range(n) if pl.gstart[i] >= 0]
    if idx_hit:
        W = Lmax + 2 * _SEED_PAD
        tw = np.full((len(idx_hit), W), dna.N, np.int8)
        tl = np.zeros(len(idx_hit), np.int32)
        meta = []
        for j, i in enumerate(idx_hit):
            si = int(genome.scaffold_index(np.asarray([pl.gstart[i]]))[0])
            t = genome.scaffold(si)
            loc = int(pl.gstart[i] - genome.offsets[si])
            ws = max(0, loc - int(pl.lclip[i]) - _SEED_PAD)
            we = min(len(t), ws + W)
            tw[j, :we - ws] = t[ws:we]
            tl[j] = we - ws
            meta.append((i, si, ws))
        qb = np.full((len(idx_hit), Lmax), dna.N, np.int8)
        for j, i in enumerate(idx_hit):
            q = queries[i]
            qb[j, :len(q)] = (dna.revcomp(np.asarray(q))
                              if pl.strand[i] else np.asarray(q))
        s, qe, te = swutil.sw_pairs(qb, ql[idx_hit], tw, np.maximum(tl, 1),
                                    BWA_PARAMS, "local", device=device)
        for j, (i, si, ws) in enumerate(meta):
            q = qb[j, :int(ql[i])]
            t = tw[j, :int(tl[j])]
            qs, ts, _ = alignment_stats(q, t, BWA_PARAMS, "local",
                                        int(qe[j]), int(te[j]))
            out[i] = (si, int(pl.strand[i]), ws + ts, ws + int(te[j]),
                      qs, int(qe[j]), int(s[j]))

    # unseeded queries: exact fallback only when the genome is small
    if len(genome.seq) <= _FALLBACK_GENOME_LIMIT:
        for i in range(n):
            if out[i] is None:
                out[i] = _best_placement(np.asarray(queries[i]), genome,
                                         device)
    return out


def extract_true_gap_seqs(gaps, genome_finished: fasta.Genome,
                          flank_left, flank_right, flank_lens,
                          index=None, device="cuda"):
    """True gap sequences from a finished genome.

    For each gap, place both flanks; when they land on the same
    finished scaffold, same strand, in order, the truth is the
    sequence between them (gnrt_gap_seqs semantics, with the
    clipped-placement filter). Returns {gap_idx: codes}.
    """
    device = entry_device(device, "extract_true_gap_seqs")
    ll, rl = flank_lens
    G = len(gaps["start"])
    live, queries = [], []
    for g in range(G):
        lseq = np.asarray(flank_left[g][:int(ll[g])])
        rseq = np.asarray(flank_right[g][:int(rl[g])])
        if len(lseq) < 20 or len(rseq) < 20:
            continue
        live.append(g)
        queries.append(lseq)
        queries.append(rseq)
    places = seeded_placements(queries, genome_finished, index=index,
                               device=device)
    out = {}
    for j, g in enumerate(live):
        lseq, rseq = queries[2 * j], queries[2 * j + 1]
        pl_, pr_ = places[2 * j], places[2 * j + 1]
        if pl_ is None or pr_ is None:
            continue
        (si1, st1, ts1, te1, qs1, qe1, sc1) = pl_
        (si2, st2, ts2, te2, qs2, qe2, sc2) = pr_
        # qualified placements: mostly unclipped
        if (qs1 > FLANK_CLIP_CUTOFF or len(lseq) - qe1 > FLANK_CLIP_CUTOFF or
                qs2 > FLANK_CLIP_CUTOFF or len(rseq) - qe2 > FLANK_CLIP_CUTOFF):
            continue
        if si1 != si2 or st1 != st2:
            continue
        t = genome_finished.scaffold(si1)
        if st1 == 0:
            start, end = te1, ts2
            if start < end:
                out[g] = t[start:end].copy()
        else:
            start, end = te2, ts1
            if start < end:
                out[g] = dna.revcomp(t[start:end].copy())
    return out


def closure_stats(picked: dict[int, np.ndarray],
                  truths: dict[int, np.ndarray], device="cuda"):
    """statistic_rslt equivalent: which fills align to truth unclipped?

    Both strands of every fill go to the kernel in one ragged batch.
    Returns dict with hit_list (closed gap indices), closed_lengths,
    and per-gap identity fraction."""
    device = entry_device(device, "closure_stats")
    live = [g for g, fill in sorted(picked.items())
            if truths.get(g) is not None and len(truths[g]) > 0
            and len(fill) > 0]
    fwd = [np.asarray(picked[g]) for g in live]
    rcs = [dna.revcomp(f) for f in fwd]
    s, qe, te = swutil.sw_ragged(fwd + rcs, [truths[g] for g in live] * 2,
                                 BWA_PARAMS, "local", device=device)
    n = len(live)
    hits, lengths, ident = [], [], {}
    for j, g in enumerate(live):
        fill, truth = fwd[j], truths[g]
        # the reverse strand wins only when it scores higher
        k = j + n if int(s[j + n]) > int(s[j]) else j
        q = rcs[j] if k >= n else fill
        qs, ts, m = alignment_stats(q, truth, BWA_PARAMS, "local",
                                    int(qe[k]), int(te[k]))
        lclip = qs
        rclip = len(fill) - int(qe[k])
        if lclip < CLIP_CUTOFF and rclip < CLIP_CUTOFF:
            hits.append(g)
            lengths.append(len(truth))
            ident[g] = m / max(len(fill), 1)
    return {"hit_list": hits, "closed_lengths": lengths,
            "identity": ident,
            "n_closed": len(hits)}


def extract_filled_regions(filled_genome: fasta.Genome, gaps,
                           fills: dict[int, np.ndarray], margin: int = 5):
    """get_filled_seq_from_out_scf equivalent: pull each filled gap's
    sequence back out of a patched scaffold FASTA.

    Accounts for the length change each upstream fill introduces on the
    same scaffold. Returns {gap_idx: codes}. Host numpy."""
    out = {}
    shift: dict[int, int] = {}
    for g in sorted(fills):
        si = int(gaps["scaffold"][g])
        s = int(gaps["local_start"][g]) - margin
        e = int(gaps["local_end"][g]) + margin
        off = shift.get(si, 0)
        seq = filled_genome.scaffold(si)
        fill_len = len(fills[g])
        out[g] = seq[s + off: s + off + fill_len].copy()
        shift[si] = off + fill_len - (e - s)
    return out


def discordant_alignment_stats(rec, readsets, truths, gaps, device="cuda"):
    """discordant_alignment_statistic.py equivalent: what fraction of
    each gap's recruited reads align to its truth sequence?"""
    device = entry_device(device, "discordant_alignment_stats")
    out = {}
    for g, truth in truths.items():
        sel = rec["gap"] == g
        n = int(sel.sum())
        if n == 0 or len(truth) < 8:
            continue
        rows = list(zip(rec["lib"][sel], rec["side"][sel],
                        rec["row"][sel]))[:256]
        L = max(max(int(readsets[li][s].length[r]) for li, s, r in rows), 8)
        qa = np.full((len(rows), L), dna.N, np.int8)
        qrc = np.full((len(rows), L), dna.N, np.int8)
        ql = np.zeros(len(rows), np.int32)
        for i, (li, s, r) in enumerate(rows):
            rs = readsets[li][s]
            ln = int(rs.length[r])
            qa[i, :ln] = rs.get_seq(r)[:ln]
            qrc[i, :ln] = dna.revcomp(qa[i, :ln])
            ql[i] = ln
        ta = np.tile(np.asarray(truth, np.int8), (len(rows), 1))
        tl = np.full(len(rows), len(truth), np.int32)
        p = SWParams(1, -4, 7, 1)
        s1, _, _ = swutil.sw_pairs(qa, ql, ta, tl, p, "local", device=device)
        s2, _, _ = swutil.sw_pairs(qrc, ql, ta, tl, p, "local",
                                   device=device)
        score = np.maximum(s1, s2)
        aligned = score >= 0.5 * ql
        out[g] = float(aligned.mean())
    return out
