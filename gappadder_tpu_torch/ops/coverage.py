"""Coverage computation, the TERefiner Coverage replacement
(counterpart of gappadder_tpu/ops/coverage.py, copied: host numpy).

Reference semantics (TERefiner's Coverage.cpp):
  calcCoverage (-B, :14-141): per-base pileup over the M-segments of
    mapped reads -> mean coverage + covered length per contig.
  calcCoveageWithCutoff (-G, :144-185): per-contig sum(M-length) /
    contig_len over reads whose M-fraction >= cutoff.

The cutoff variant is exact from the columnar M-sums. The per-base
variant is EXACT when the caller retains per-record CIGARs
(io.bam.read_bam(keep_cigars=True)): true M-segment pileup matching
Coverage.cpp:14-141, with D/N ops advancing the target cursor. Without
CIGARs it falls back to approximating each read's M-segments with the
single span [pos, pos+nmatch) (interior indels shift bases by at most
the indel length).
"""

from __future__ import annotations

import numpy as np

# CIGAR op indices (MIDNSHP=X): which ops consume the target, and
# which deposit coverage
_CONSUMES_TARGET = np.array([1, 0, 1, 1, 0, 0, 0, 1, 1], bool)  # M D N = X
_IS_MATCH = np.array([1, 0, 0, 0, 0, 0, 0, 1, 1], bool)         # M = X


def m_segments(pos, cig_op, cig_ln, cig_off):
    """Exact aligned M-segments from retained CIGARs.

    Returns (rec_idx, seg_start, seg_end) int64 arrays: one row per
    M/=/X op, in target coordinates (Coverage.cpp:74-141 walk)."""
    cig_op = np.asarray(cig_op, np.int64)
    cig_ln = np.asarray(cig_ln, np.int64)
    cig_off = np.asarray(cig_off, np.int64)
    n_ops = len(cig_op)
    if n_ops == 0:
        z = np.zeros(0, np.int64)
        return z, z, z
    # record index of every op
    rec = np.repeat(np.arange(len(cig_off) - 1), np.diff(cig_off))
    adv = np.where(_CONSUMES_TARGET[cig_op], cig_ln, 0)
    cum = np.concatenate([[0], np.cumsum(adv)])
    # target offset of each op within its record = prefix advance
    base = cum[cig_off[rec]]
    op_start = np.asarray(pos, np.int64)[rec] + cum[:-1] - base
    is_m = _IS_MATCH[cig_op]
    return rec[is_m], op_start[is_m], op_start[is_m] + cig_ln[is_m]


def coverage_with_cutoff(tid, nmatch, read_len, contig_lens,
                         cutoff: float = 0.99):
    """Per-contig mean coverage counting reads with M-fraction >= cutoff.

    Returns float64 [C] mean coverage (reference -G mode output,
    refiner.cpp:1381-1451)."""
    C = len(contig_lens)
    ok = (read_len > 0) & (nmatch >= cutoff * read_len) & (tid >= 0) & \
        (tid < C)
    total = np.zeros(C, np.int64)
    np.add.at(total, tid[ok], nmatch[ok].astype(np.int64))
    lens = np.maximum(np.asarray(contig_lens, np.int64), 1)
    return total / lens


def per_base_coverage(tid, pos, nmatch, contig_lens, cigars=None):
    """Per-base pileup; returns (mean_cov [C], covered_len [C]).

    Reference -B mode (Coverage.cpp:14-141). ``cigars`` =
    (cig_op, cig_ln, cig_off) retained from read_bam(keep_cigars=True)
    makes the pileup exact over true M-segments; otherwise each read
    contributes the approximate span [pos, pos+nmatch)."""
    C = len(contig_lens)
    tid = np.asarray(tid)
    pos = np.asarray(pos)
    nmatch = np.asarray(nmatch)
    if cigars is not None:
        rec, seg_s, seg_e = m_segments(pos, *cigars)
        seg_tid = tid[rec]
    else:
        sel0 = nmatch > 0
        seg_tid = tid[sel0]
        seg_s = pos[sel0].astype(np.int64)
        seg_e = seg_s + nmatch[sel0].astype(np.int64)
    out_mean = np.zeros(C, np.float64)
    out_cov = np.zeros(C, np.int64)
    for c in range(C):
        L = int(contig_lens[c])
        if L <= 0:
            continue
        sel = seg_tid == c
        if not sel.any():
            continue
        diff = np.zeros(L + 1, np.int64)
        s = np.clip(seg_s[sel], 0, L - 1)
        e = np.clip(seg_e[sel], 0, L)
        np.add.at(diff, s, 1)
        np.add.at(diff, e, -1)
        depth = np.cumsum(diff[:-1])
        out_mean[c] = depth.mean()
        out_cov[c] = int((depth > 0).sum())
    return out_mean, out_cov
