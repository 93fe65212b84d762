"""Round-2 read rescue + HQ clip augmentation (counterpart of
gappadder_tpu/pipeline/rescue.py).

Both-unmapped rescue (BothUnmappedReadsCollector,
collect_both_unmapped_reads.py): pairs whose BOTH ends
failed to map to the draft are matched against the round-1 contigs of
still-open gaps (the reference runs bwa mem -a against a pan-gap
contig FASTA named "<gap_id>-<contig>"); a read hitting a gap's
contigs joins that gap's read set, and its mate comes along when the
mate has no hit in the same gap.

HQ clip augmentation (assemble_gaps.py:166-217): each open gap's
high-quality (mapq==60-anchored) reads are aligned to its contigs;
reads CLIPPED on >= 2 different contigs are appended to the original
(pre-merge) contig set as pseudo-contigs before the final re-merge —
they are potential junction spanners.

Alignment here is the seed-and-extend matcher (ops/seedmatch) + SW
verification instead of bwa. The index, the k-mer join and both SW
passes run on `device` (the card unless the caller asks for "cpu");
the votes and the mate bookkeeping are host code, copied.
"""

from __future__ import annotations

import numpy as np
import torch

from .. import dna, entry_device
from ..config import Config
from ..ops import seedmatch
from ..ops.sw_host import BWA_PARAMS
from ..utils.meters import span

SEED_K = 19
MIN_VOTES = 2
MIN_SCORE = 30          # bwa mem default -T
CLIP_MIN = 5            # soft-clip length that counts as "clipped"


def _gather_reads(entries, readsets):
    """entries: list[(lib, side, row)] -> padded arrays + lens."""
    if not entries:
        return (np.zeros((0, 1), np.int8), np.zeros(0, np.int32))
    L = max(int(readsets[li][s].length[r]) for li, s, r in entries)
    L = max(L, 1)
    seq = np.full((len(entries), L), dna.N, np.int8)
    lens = np.zeros(len(entries), np.int32)
    for i, (li, s, r) in enumerate(entries):
        rs = readsets[li][s]
        ln = int(rs.length[r])
        seq[i, :ln] = rs.get_seq(r)[:ln]
        lens[i] = ln
    return seq, lens


BAND = 64   # seed-window half-width for banded verification


def _verify_hits(read_seq, read_lens, pairs, contig_arr, contig_lens,
                 min_score=MIN_SCORE, device="cuda"):
    """SW-verify (read, strand, contig[, votes, diag]) candidates.

    When pairs carry a seed diagonal, the target is sliced to a
    [diag-BAND, diag+read_len+BAND) window — the seed-anchored banded
    verification that replaces full-contig DP (8x+ less work on long
    contigs). Returns surviving (read, strand, contig, score, clipped).
    """
    if not pairs:
        return []
    B = len(pairs)
    L = read_seq.shape[1]
    has_diag = len(pairs[0]) >= 5
    W = L + 2 * BAND if has_diag else contig_arr.shape[1]
    q = np.full((B, L), dna.N, np.int8)
    ql = np.zeros(B, np.int32)
    t = np.full((B, W), dna.N, np.int8)
    tl = np.zeros(B, np.int32)
    for i, p in enumerate(pairs):
        r, s, c = p[0], p[1], p[2]
        ln = int(read_lens[r])
        if s == 0:
            q[i, :ln] = read_seq[r, :ln]
        else:
            q[i, :ln] = dna.revcomp(read_seq[r, :ln])
        ql[i] = ln
        clen = int(contig_lens[c])
        if has_diag:
            lo = max(int(p[4]) - BAND, 0)
            hi = min(lo + W, clen)
            t[i, :hi - lo] = contig_arr[c][lo:hi]
            tl[i] = hi - lo
        else:
            t[i, :clen] = contig_arr[c][:clen]
            tl[i] = clen
    from ..ops.swutil import sw_pairs
    score, qe, te = sw_pairs(q, ql, t, tl, BWA_PARAMS, "local",
                             device=device)
    # qstart without traceback: align the REVERSED PREFIXES q[:qe],
    # t[:te] — anchoring at the chosen end point so that under score
    # ties qstart belongs to the SAME optimal alignment as (qe, te)
    # (reversing the whole pair could pick a different co-optimal hit)
    qr = np.full_like(q, dna.N)
    tr = np.full_like(t, dna.N)
    for i in range(B):
        e1, e2 = int(qe[i]), int(te[i])
        qr[i, :e1] = q[i, :e1][::-1]
        tr[i, :e2] = t[i, :e2][::-1]
    _, qe_rev, _ = sw_pairs(qr, np.asarray(qe, np.int32),
                            tr, np.maximum(np.asarray(te, np.int32), 1),
                            BWA_PARAMS, "local", device=device)
    out = []
    for i, p in enumerate(pairs):
        r, s, c = p[0], p[1], p[2]
        if score[i] >= min_score:
            # CIGAR-style clip typing (Alignment.cpp clip semantics):
            # soft clip = query bases outside the local alignment span
            # (segment start = qe - consumed-end of the reversed prefix)
            lclip = int(qe[i]) - int(qe_rev[i])
            rclip = int(ql[i]) - int(qe[i])
            clipped = lclip >= CLIP_MIN or rclip >= CLIP_MIN
            out.append((r, s, c, int(score[i]), clipped))
    return out


def _on(x, device):
    return torch.from_numpy(np.ascontiguousarray(x)).to(device)


def rescue_both_unmapped(cfg: Config, ws, readsets, contig_store,
                         open_gaps: list[int], device="cuda"):
    """Returns extra per-gap read entries {gap: [(lib, side, row)]}.
    Its span `assembly.rescue` counts the both-unmapped `reads` matched,
    the `contigs` indexed, the `candidates` past the vote, those
    `verified`, and the entries `recruited` (mates included)."""
    device = entry_device(device, "rescue_both_unmapped")
    with span("assembly.rescue") as sp:
        return _rescue(ws, readsets, contig_store, open_gaps, device, sp)


def _rescue(ws, readsets, contig_store, open_gaps, device, sp):
    if not ws.has_arrays("both_unmapped") or not open_gaps:
        return {}
    bu = ws.load_arrays("both_unmapped")
    entries = list(zip(bu["lib"], bu["side"], bu["row"]))
    if not entries:
        return {}

    # pan-gap contig array with (gap, local) ownership
    contigs, owners = [], []
    for g in open_gaps:
        s, l, n, _names = contig_store[g]
        for i in range(n):
            contigs.append(np.asarray(s[i][:int(l[i])]))
            owners.append(g)
    if not contigs:
        return {}
    Lc = max(len(c) for c in contigs)
    carr = np.full((len(contigs), max(Lc, SEED_K)), dna.N, np.int8)
    clens = np.zeros(len(contigs), np.int32)
    for i, c in enumerate(contigs):
        carr[i, :len(c)] = c
        clens[i] = len(c)
    owners = np.asarray(owners)

    index = seedmatch.build_index(_on(carr, device), _on(clens, device),
                                  SEED_K)
    rseq, rlens = _gather_reads(entries, readsets)
    if rseq.shape[1] < SEED_K:
        return {}
    sp.add(reads=len(entries), contigs=len(contigs))
    extra: dict[int, list] = {}
    B = 4096
    mate_hits: dict[tuple[int, int], set[int]] = {}
    hits_list = []
    for lo in range(0, len(entries), B):
        hi = min(lo + B, len(entries))
        votes, diags = seedmatch.match_candidates(
            _on(rseq[lo:hi], device), _on(rlens[lo:hi], device),
            index["limbs"], index["contig"], k=SEED_K,
            index_pos=index["pos"])
        pairs = seedmatch.vote_pairs(votes, MIN_VOTES, diag_votes=diags)
        verified = _verify_hits(rseq[lo:hi], rlens[lo:hi], pairs,
                                carr, clens, device=device)
        sp.add(candidates=len(pairs), verified=len(verified))
        for (r, s, c, score, _cl) in verified:
            li, side, row = entries[lo + r]
            g = int(owners[c])
            hits_list.append((int(li), int(side), int(row), g))
            mate_hits.setdefault((li, row), set()).add(g)

    # mate recruitment: the reference adds the mate when it is unmapped
    # by the contig alignment or hit a different gap
    # (collect_both_unmapped_reads.py:92-104); a mate that hit the SAME
    # gap is added by its own record — so the net effect is that the
    # whole pair always joins the gap. Mate rows are resolved by name
    # hash (left/right FASTQ files need not be row-aligned).
    mate_row_maps = {}
    for li in range(len(readsets)):
        for side in (0, 1):
            rs = readsets[li][side]
            if rs is not None and rs.n:
                order = np.argsort(rs.name_hash, kind="stable")
                mate_row_maps[(li, side)] = (rs.name_hash[order], order)

    def mate_row(li, side, row):
        rs = readsets[li][side]
        other = readsets[li][1 - side]
        if rs is None or other is None or (li, 1 - side) not in mate_row_maps:
            return None
        h = rs.name_hash[row]
        sh, order = mate_row_maps[(li, 1 - side)]
        i = np.searchsorted(sh, h)
        if i < len(sh) and sh[i] == h:
            return int(order[i])
        return None

    added = set()
    for (li, side, row, g) in hits_list:
        key = (g, li, side, row)
        if key not in added:
            added.add(key)
            extra.setdefault(g, []).append((li, side, row))
        mrow = mate_row(li, side, row)
        if mrow is not None:
            mkey = (g, li, 1 - side, mrow)
            if mkey not in added:
                added.add(mkey)
                extra.setdefault(g, []).append((li, 1 - side, mrow))
    sp.add(recruited=len(added))
    return extra


def hq_pseudo_contigs(cfg: Config, gap: int, contig_store, readsets,
                      hq_entries: list[tuple[int, int, int]], device="cuda"):
    """Reads clipped on >=2 contigs of this gap -> pseudo-contig codes.
    Its span `assembly.hq` counts the HQ `reads` matched, the
    `candidates` past the vote and the `pseudo`-contigs made."""
    device = entry_device(device, "hq_pseudo_contigs")
    with span("assembly.hq") as sp:
        return _hq_pseudo(gap, contig_store, readsets, hq_entries, device,
                          sp)


def _hq_pseudo(gap, contig_store, readsets, hq_entries, device, sp):
    s, l, n, _ = contig_store[gap]
    if n == 0 or not hq_entries:
        return []
    carr = np.asarray(s[:n])
    clens = np.asarray(l[:n])
    if int(clens.max(initial=0)) < SEED_K:
        return []
    index = seedmatch.build_index(_on(carr, device), _on(clens, device),
                                  SEED_K)
    rseq, rlens = _gather_reads(hq_entries, readsets)
    if rseq.shape[0] == 0 or rseq.shape[1] < SEED_K:
        return []
    sp.add(reads=len(hq_entries))
    votes, diags = seedmatch.match_candidates(
        _on(rseq, device), _on(rlens, device), index["limbs"],
        index["contig"], k=SEED_K, index_pos=index["pos"])
    pairs = seedmatch.vote_pairs(votes, MIN_VOTES, diag_votes=diags)
    sp.add(candidates=len(pairs))
    verified = _verify_hits(rseq, rlens, pairs, carr, clens, device=device)
    per_read: dict[int, set[int]] = {}
    for (r, s_, c, score, clipped) in verified:
        if clipped:
            per_read.setdefault(r, set()).add(c)
    out = []
    for r, cset in sorted(per_read.items()):
        if len(cset) >= 2:
            out.append(rseq[r][:int(rlens[r])].copy())
    sp.add(pseudo=len(out))
    return out
