"""Whole-genome minimizer seed index and short-read mapper (counterpart
of gappadder_tpu/ops/minimap.py, copied: host numpy, the port imports
nothing of the JAX package).

Collect's self-mapping mode for a library without a BAM: a
minimizer-subsampled k-mer index of the whole draft (the standard
(w, k)-minimizer scheme) and a vote-and-verify placement pass give the
columnar Alignments the classification consumes, and, through
io.bam.write_bam_columns, a standard BAM.

Index build and lookup are columnar numpy passes (chunked, bounded
memory); candidate verification is a gather and compare over all
candidates at once. Diagonal voting collapses seed chaining to exact
diagonal bins, merged with their neighbours within +/- 4 for small
indels.

Positions are global offsets into Genome.seq (scaffold separators are
non-ACGT codes, so no k-mer window crosses a boundary);
`Genome.scaffold_index` / `to_local` convert to per-scaffold BAM
coordinates.
"""

from __future__ import annotations

import dataclasses

import numpy as np

from .. import dna
from ..io import fasta

_U64 = np.uint64
_INVALID = _U64(0xFFFFFFFFFFFFFFFF)


def _splitmix64(x: np.ndarray) -> np.ndarray:
    """SplitMix64 finalizer: uniform hash of packed k-mer keys so
    minimizer sampling is unbiased by base composition."""
    x = x.astype(_U64, copy=True)
    x += _U64(0x9E3779B97F4A7C15)
    x = (x ^ (x >> _U64(30))) * _U64(0xBF58476D1CE4E5B9)
    x = (x ^ (x >> _U64(27))) * _U64(0x94D049BB133111EB)
    return x ^ (x >> _U64(31))


def canonical_kmer_hashes(codes: np.ndarray, k: int):
    """Canonical k-mer hashes of one code array.

    Returns (hashes uint64 [P], strand uint8 [P]) with P = len-k+1;
    windows containing any non-ACGT code hash to _INVALID. strand=1
    means the reverse complement was the canonical form.
    """
    codes = np.asarray(codes, np.int8)
    L = len(codes)
    P = L - k + 1
    if P <= 0:
        return np.zeros(0, _U64), np.zeros(0, np.uint8)
    bad = (codes < 0) | (codes > 3)
    safe = np.where(bad, 0, codes).astype(_U64)
    comp = _U64(3) - safe
    fwd = np.zeros(P, _U64)
    rev = np.zeros(P, _U64)
    for j in range(k):
        fwd = (fwd << _U64(2)) | safe[j:j + P]
    for j in range(k - 1, -1, -1):
        rev = (rev << _U64(2)) | comp[j:j + P]
    strand = (rev < fwd).astype(np.uint8)
    canon = np.minimum(fwd, rev)
    h = _splitmix64(canon)
    cb = np.zeros(L + 1, np.int32)
    np.cumsum(bad, out=cb[1:])
    win_bad = (cb[k:] - cb[:P]) > 0
    h[win_bad] = _INVALID
    return h, strand


def _minimizer_positions(h: np.ndarray, w: int) -> np.ndarray:
    """Positions selected by the (w,k)-minimizer rule: for every window
    of w consecutive k-mers, the leftmost position of the minimum hash."""
    P = len(h)
    if P == 0:
        return np.zeros(0, np.int64)
    if P <= w:
        m = int(np.argmin(h))
        return (np.array([m], np.int64) if h[m] != _INVALID
                else np.zeros(0, np.int64))
    win = np.lib.stride_tricks.sliding_window_view(h, w)
    picks = np.arange(len(win), dtype=np.int64) + np.argmin(win, axis=1)
    picks = np.unique(picks)
    return picks[h[picks] != _INVALID]


@dataclasses.dataclass
class MinimizerIndex:
    """Sorted (hash -> global position, strand) table of the draft."""
    k: int
    w: int
    keys: np.ndarray      # uint64 [M] sorted
    pos: np.ndarray       # int64 [M] global position in Genome.seq
    strand: np.ndarray    # uint8 [M]
    max_occ: int = 64     # repeat cutoff: keys more frequent are skipped


def build_index(genome: fasta.Genome, k: int = 17, w: int = 8,
                chunk: int = 32 << 20, max_occ: int = 64) -> MinimizerIndex:
    """Minimizer index of the whole draft, built in bounded-memory
    chunks (k-1+w-1 overlap keeps windows spanning chunk cuts)."""
    seq = genome.seq
    L = len(seq)
    overlap = k + w - 2
    keys_l, pos_l, str_l = [], [], []
    start = 0
    while start < L:
        end = min(L, start + chunk)
        lo = max(0, start - overlap)
        h, s = canonical_kmer_hashes(seq[lo:end], k)
        picks = _minimizer_positions(h, w)
        # keep every pick: windows spanning the chunk cut are evaluated
        # by BOTH chunks (overlap = k+w-2), so boundary minimizers are
        # duplicated here and deduped by position below — never lost
        # (index contents must not depend on chunk size).
        keys_l.append(h[picks])
        pos_l.append(picks + lo)
        str_l.append(s[picks])
        start = end
    keys = np.concatenate(keys_l) if keys_l else np.zeros(0, _U64)
    pos = np.concatenate(pos_l) if pos_l else np.zeros(0, np.int64)
    strand = np.concatenate(str_l) if str_l else np.zeros(0, np.uint8)
    pos, uniq_idx = np.unique(pos, return_index=True)
    keys = keys[uniq_idx]
    strand = strand[uniq_idx]
    order = np.argsort(keys, kind="stable")
    return MinimizerIndex(k=k, w=w, keys=keys[order], pos=pos[order],
                          strand=strand[order], max_occ=max_occ)


@dataclasses.dataclass
class Placements:
    """Best placement per read (global coordinates)."""
    gstart: np.ndarray    # int64 [N] global start of the ALIGNED part
    #                       (i.e. after the left clip; -1 unmapped)
    strand: np.ndarray    # uint8 [N] 1 = reverse
    nmatch: np.ndarray    # int32 [N] matching bases in the kept segment
    lclip: np.ndarray     # int32 [N] soft clip (mapping orientation)
    rclip: np.ndarray     # int32 [N]
    mapq: np.ndarray      # int32 [N]


def map_reads(genome: fasta.Genome, index: MinimizerIndex,
              seq: np.ndarray, length: np.ndarray,
              min_votes: int = 2, min_identity: float = 0.8,
              min_score: int = 30,
              max_hits_per_seed: int = 16) -> Placements:
    """Place each read on the draft: minimizer lookup -> exact-diagonal
    voting -> gather-and-compare verification with Kadane soft-clipping
    (match +1 / mismatch -4, the bwa-mem scoring shape, so low-identity
    read ends — e.g. bases hanging into a gap's N-run — are clipped the
    way bwa would) -> mapq from vote margin.

    seq: int8 [N, Lmax]; length: int32 [N].
    """
    N, Lmax = seq.shape
    k, w = index.k, index.w

    # ---- read minimizers (vectorized over the batch) --------------------
    flat = []
    for i in range(N):
        ln = int(length[i])
        h, s = canonical_kmer_hashes(seq[i, :ln], k)
        picks = _minimizer_positions(h, w)
        flat.append((i, ln, picks, h[picks], s[picks]))
    if not flat:
        z = np.zeros(0, np.int64)
        return Placements(z, z.astype(np.uint8), z.astype(np.int32),
                          z.astype(np.int32), z.astype(np.int32),
                          z.astype(np.int32))
    rid = np.concatenate([np.full(len(p), i, np.int32)
                          for i, _, p, _, _ in flat])
    rpos = np.concatenate([p for _, _, p, _, _ in flat])
    rkey = np.concatenate([hk for _, _, _, hk, _ in flat])
    rstr = np.concatenate([s for _, _, _, _, s in flat])
    rlen_of = length.astype(np.int64)

    # ---- index lookup with repeat cutoff ---------------------------------
    lo = np.searchsorted(index.keys, rkey, side="left")
    hi = np.searchsorted(index.keys, rkey, side="right")
    cnt = hi - lo
    ok = (cnt > 0) & (cnt <= index.max_occ)
    take = np.minimum(cnt, max_hits_per_seed)
    reps = np.where(ok, take, 0)
    src = np.repeat(np.arange(len(rkey)), reps)
    # offsets 0..reps-1 within each seed's hit range
    off = np.arange(len(src)) - np.repeat(
        np.cumsum(reps) - reps, reps)
    ipos = index.pos[lo[src] + off]
    istr = index.strand[lo[src] + off]

    mstrand = (rstr[src] ^ istr).astype(np.int64)     # 0 fwd, 1 rev
    rp = rpos[src]
    rl = rlen_of[rid[src]]
    # fwd: gstart = ipos - rp; rev: gstart = ipos + rp - (rl - k)
    gstart = np.where(mstrand == 0, ipos - rp, ipos + rp - (rl - k))
    reads = rid[src].astype(np.int64)

    # ---- diagonal voting (exact bins + neighbor merge) -------------------
    # key = (read, strand, gstart); votes = multiplicity
    vkey = (reads << 34) | (mstrand << 33) | (gstart + (1 << 32))
    vkey, votes = np.unique(vkey, return_counts=True)
    # merge votes from gstarts within +/-4 (small indels / edge wobble)
    merged = votes.astype(np.int64).copy()
    for d in (1, 2, 3, 4):
        same = (vkey[d:] - vkey[:-d]) <= d  # same read+strand, close diag
        merged[d:][same] += votes[:-d][same]
        merged[:-d][same] += votes[d:][same]

    vread = (vkey >> 34).astype(np.int64)
    best_votes = np.zeros(N, np.int64)
    np.maximum.at(best_votes, vread, merged)
    is_best = merged == best_votes[vread]
    # leftmost best candidate per read (deterministic tie-break)
    first_best = np.full(N, len(vkey), np.int64)
    np.minimum.at(first_best, vread[is_best], np.flatnonzero(is_best))
    have = first_best < len(vkey)
    cand = np.clip(first_best, 0, max(len(vkey) - 1, 0))
    # second-best vote count: EVERY entry of the same read whose vkey
    # (read|strand|gstart) is within 4 of the winner belongs to the
    # winning diagonal group and must not count as a competitor —
    # otherwise a uniquely-mapped read with seed wobble across adjacent
    # bins gets margin ~1 and a junk mapq.
    winner_key = np.where(have, vkey[cand].astype(np.int64), -(1 << 62))
    far = np.abs(vkey.astype(np.int64) - winner_key[vread]) > 4
    second = np.zeros(N, np.int64)
    np.maximum.at(second, vread[far], merged[far])

    c_votes = np.where(have, merged[cand], 0)
    c_strand = np.where(have, (vkey[cand] >> 33) & 1, 0).astype(np.uint8)
    c_gstart = np.where(have, (vkey[cand] & ((1 << 33) - 1)) - (1 << 32),
                        -1)
    mapped = have & (c_votes >= min_votes)

    # ---- verification: gather genome slice, Kadane soft-clip ------------
    glen = len(genome.seq)
    rl_all = rlen_of
    gs = np.where(mapped, c_gstart, 0)
    cols = gs[:, None] + np.arange(Lmax)[None, :]
    inb = (cols >= 0) & (cols < glen) & (np.arange(Lmax)[None, :] <
                                         rl_all[:, None])
    gseq = genome.seq[np.clip(cols, 0, glen - 1)]
    # read bases in mapping orientation
    rseq = seq.copy()
    for i in np.flatnonzero(mapped & (c_strand == 1)):
        ln = int(length[i])
        rseq[i, :ln] = dna.revcomp(seq[i, :ln])
    match = inb & (gseq == rseq) & (gseq <= 3)
    # restrict to the read's own scaffold (no crossing separators)
    scaf = genome.scaffold_index(np.clip(gs, 0, max(glen - 1, 0)))
    scaf = np.clip(scaf, 0, max(genome.num_scaffolds - 1, 0))
    if genome.num_scaffolds:
        s_lo = genome.offsets[scaf]
        s_hi = genome.offsets[scaf] + genome.lengths[scaf]
        match = match & (cols >= s_lo[:, None]) & (cols < s_hi[:, None])

    # max-sum segment per row (match +1, mismatch -4, padding -inf):
    # the kept segment is the alignment, the rest are soft clips
    in_read = np.arange(Lmax)[None, :] < rl_all[:, None]
    s = np.where(match, 1, np.where(in_read, -4, -10 * Lmax)).astype(
        np.int64)
    pref = np.zeros((N, Lmax + 1), np.int64)
    np.cumsum(s, axis=1, out=pref[:, 1:])
    cummin = np.minimum.accumulate(pref, axis=1)
    gain = pref[:, 1:] - cummin[:, :-1]
    seg_end = np.argmax(gain, axis=1).astype(np.int64) + 1
    seg_score = gain[np.arange(N), seg_end - 1]
    # segment start = LAST index achieving the running prefix minimum
    # (maximum.accumulate resolves prefix-min ties to the latest index,
    # i.e. the shortest co-optimal segment: zero-sum edge regions are
    # clipped rather than absorbed — intended, keeps lclip/rclip tight;
    # score is unaffected, nmatch counts only the kept segment)
    is_min = pref == cummin
    min_idx = np.maximum.accumulate(
        np.where(is_min, np.arange(Lmax + 1)[None, :], 0), axis=1)
    seg_start = min_idx[np.arange(N), seg_end - 1]

    mpref = np.zeros((N, Lmax + 1), np.int64)
    np.cumsum(match, axis=1, out=mpref[:, 1:])
    nmatch = (mpref[np.arange(N), seg_end] -
              mpref[np.arange(N), seg_start]).astype(np.int32)
    seg_len = (seg_end - seg_start).astype(np.int32)
    good = mapped & (seg_score >= min_score) & \
        (nmatch >= (min_identity * seg_len).astype(np.int32))

    lclip = np.where(good, seg_start, 0).astype(np.int32)
    rclip = np.where(good, rl_all - seg_end, 0).astype(np.int32)

    margin = c_votes - second
    mapq = np.where(second == 0, 60,
                    np.clip(6 * margin, 0, 60)).astype(np.int32)
    mapq = np.where(good, mapq, 0)

    return Placements(
        gstart=np.where(good, c_gstart + lclip, -1),
        strand=np.where(good, c_strand, 0).astype(np.uint8),
        nmatch=np.where(good, nmatch, 0),
        lclip=lclip, rclip=rclip, mapq=mapq)


def map_library(genome: fasta.Genome, index: MinimizerIndex,
                left, right, batch: int = 1 << 15, **map_kwargs):
    """Map a paired library (two fastq.ReadSets) and emit the columnar
    Alignments the collect stage consumes, in place of the external
    `bwa mem` BAM the reference needs (its configuration's
    "alignments").

    Pairing convention (matching what a mapper writes): left = first in
    pair (0x40), right = second (0x80); an unmapped read is placed at
    its mapped mate's coordinate; tlen is signed outer distance on the
    leftmost read. Read order in the output is (all left rows, then all
    right rows), so row i pairs with row n_left + i.
    """
    from ..io import bam as bam_io

    n_l, n_r = left.n, right.n
    assert n_l == n_r, "paired library FASTQs differ in length"

    def run(rs):
        outs = []
        for lo in range(0, rs.n, batch):
            hi = min(lo + batch, rs.n)
            outs.append(map_reads(genome, index, rs.seq[lo:hi],
                                  rs.length[lo:hi], **map_kwargs))
        return Placements(*(np.concatenate([getattr(o, f.name)
                                            for o in outs])
                            for f in dataclasses.fields(Placements)))

    pl, pr = run(left), run(right)
    n = n_l

    def side_cols(p, q, first: bool, rs, mate_rs):
        """Columns for one side; q is the mate's placements."""
        self_ok = p.gstart >= 0
        mate_ok = q.gstart >= 0
        scafs = genome.scaffold_index(np.clip(p.gstart, 0, None))
        scafm = genome.scaffold_index(np.clip(q.gstart, 0, None))
        tid = np.where(self_ok, scafs, np.where(mate_ok, scafm, -1))
        loc = genome.to_local(np.clip(p.gstart, 0, None)).astype(np.int64)
        locm = genome.to_local(np.clip(q.gstart, 0, None)).astype(np.int64)
        pos = np.where(self_ok, loc, np.where(mate_ok, locm, -1))
        mtid = np.where(mate_ok, scafm, np.where(self_ok, scafs, -1))
        mpos = np.where(mate_ok, locm, np.where(self_ok, loc, -1))

        flag = np.full(n, 0x1 | (0x40 if first else 0x80), np.int32)
        flag |= np.where(self_ok, 0, 0x4)
        flag |= np.where(mate_ok, 0, 0x8)
        flag |= np.where(self_ok & (p.strand == 1), 0x10, 0)
        flag |= np.where(mate_ok & (q.strand == 1), 0x20, 0)

        # aligned span (the Alignments.nmatch contract is the CIGAR
        # M/=/X sum — includes mismatches; our verifier emits no
        # indels, so span = len - clips exactly)
        span_s = rs.length.astype(np.int64) - p.lclip - p.rclip
        span_m = mate_rs.length.astype(np.int64) - q.lclip - q.rclip
        both = self_ok & mate_ok & (scafs == scafm)
        lo_ = np.minimum(loc, locm)
        hi_ = np.maximum(loc + span_s, locm + span_m)
        mag = hi_ - lo_
        tlen = np.where(both,
                        np.where(loc < locm, mag,
                                 np.where(loc > locm, -mag,
                                          mag if first else -mag)),
                        0)
        # proper pair: both mapped, same scaffold, FR orientation
        fr = both & (p.strand != q.strand) & \
            (np.where(p.strand == 0, loc <= locm, locm <= loc))
        flag |= np.where(fr, 0x2, 0)
        return dict(tid=tid.astype(np.int32), pos=pos.astype(np.int32),
                    flag=flag, mapq=np.where(self_ok, p.mapq, 0),
                    mtid=mtid.astype(np.int32),
                    mpos=mpos.astype(np.int32),
                    tlen=tlen.astype(np.int32),
                    lclip=np.asarray(p.lclip, np.int32),
                    rclip=np.asarray(p.rclip, np.int32),
                    nmatch=np.where(self_ok, span_s, 0).astype(np.int32),
                    read_len=np.asarray(rs.length, np.int32))

    cl = side_cols(pl, pr, True, left, right)
    cr = side_cols(pr, pl, False, right, left)
    cols = {k: np.concatenate([cl[k], cr[k]]) for k in cl}
    return bam_io.Alignments(
        refs=list(genome.names), names=None,
        name_hash=np.concatenate([left.name_hash, right.name_hash]),
        **cols)
