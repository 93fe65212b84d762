"""Scoring parameters, the numpy affine-gap DP oracle and the host
traceback.

Exact full-matrix DP, vectorised over anti-diagonals; the tests hold
the batched SW implementations against it. `alignment_stats_batch` (one
batched DP fill for all winners of a pass, then a walk back along each
path, as the JAX package traces) is the plain twin of Pick's traceback
kernel `csrc/traceback.cu` (`traceback_dp.alignment_stats_device`): on
the card Pick's tracebacks run in that kernel, on the CPU here.

Modes:
  local      Smith-Waterman: H clamped at 0, best anywhere.
  overlap    free leading/trailing gaps on both sequences, best on the
             last row or column (within `end_slack`).
  extend     anchored at (0,0), best anywhere.
  fit        query-global / target-local: the query is consumed end to
             end, the target window is free.
"""

from __future__ import annotations

import dataclasses

import numpy as np

NEG = -(1 << 28)


@dataclasses.dataclass(frozen=True)
class SWParams:
    match: int = 1
    mismatch: int = -1
    gap_open: int = 1        # cost of first gap base (positive numbers)
    gap_extend: int = 1      # cost per additional gap base


BWA_PARAMS = SWParams(match=1, mismatch=-4, gap_open=7, gap_extend=1)
"""bwa mem default scoring (A=1 B=4 O=6 E=1; first gap base costs O+E)."""


def dp_matrices(q, t, p: SWParams, mode: str):
    """Fill full H, E, F matrices (int64), vectorised per anti-diagonal."""
    q = np.asarray(q, np.int64)
    t = np.asarray(t, np.int64)
    n, m = len(q), len(t)
    H = np.zeros((n + 1, m + 1), np.int64)
    E = np.full((n + 1, m + 1), NEG, np.int64)
    F = np.full((n + 1, m + 1), NEG, np.int64)
    go, ge = p.gap_open, p.gap_extend
    if mode == "extend":
        H[0, 1:] = NEG
        H[1:, 0] = NEG
    elif mode == "fit":
        col = -(go + ge * np.arange(0, n, dtype=np.int64))
        H[1:, 0] = col
        F[1:, 0] = col
    for d in range(2, n + m + 1):
        ilo = max(1, d - m)
        ihi = min(n, d - 1)
        if ilo > ihi:
            continue
        i = np.arange(ilo, ihi + 1)
        j = d - i
        E[i, j] = np.maximum(H[i, j - 1] - go, E[i, j - 1] - ge)
        F[i, j] = np.maximum(H[i - 1, j] - go, F[i - 1, j] - ge)
        s = np.where((q[i - 1] == t[j - 1]) & (q[i - 1] < 4),
                     p.match, p.mismatch)
        h = np.maximum(H[i - 1, j - 1] + s, np.maximum(E[i, j], F[i, j]))
        if mode == "local":
            h = np.maximum(h, 0)
        H[i, j] = h
    return H, E, F


def sw_np(q: np.ndarray, t: np.ndarray, p: SWParams = SWParams(),
          mode: str = "local", end_slack: int = 0):
    """Full DP. Returns (score, qend, tend, H) with 1-based ends
    (qend/tend = number of consumed bases of q/t at the best cell).

    end_slack (overlap mode only): also consider end cells up to
    `end_slack` rows/cols before the last.
    """
    n, m = len(q), len(t)
    H, _, _ = dp_matrices(q, t, p, mode)
    if mode == "overlap":
        cand = []
        for c in range(end_slack + 1):
            if n - c >= 0:
                cand += [(H[n - c, j], n - c, j) for j in range(m + 1)]
            if m - c >= 0:
                cand += [(H[i, m - c], i, m - c) for i in range(n + 1)]
        score, qend, tend = max(cand, key=lambda x: (x[0], x[1], x[2]))
    elif mode == "fit":
        cand = [(H[n, j], n, j) for j in range(m + 1)]
        score, qend, tend = max(cand, key=lambda x: (x[0], x[1], x[2]))
    else:
        flat = np.argmax(H)
        qend, tend = divmod(int(flat), m + 1)
        score = int(H[qend, tend])
    return int(score), int(qend), int(tend), H


def dp_matrices_batch(q, ql, t, tl, p: SWParams, mode: str):
    """Batched full DP fill: one anti-diagonal sweep for ALL pairs.

    q: [B, n] codes (padding arbitrary; rows beyond ql never matter for
    a traceback that starts inside the true region), t: [B, m].
    Returns (H, E, F) int32 [B, n+1, m+1].

    Replaces per-pair dp_matrices calls when many winning hits need a
    host traceback (the pick/merge host cost center): the Python
    anti-diagonal loop runs once for the whole batch instead of once
    per pair.
    """
    q = np.asarray(q, np.int32)
    t = np.asarray(t, np.int32)
    B, n = q.shape
    m = t.shape[1]
    NEG32 = np.int32(-(1 << 28))
    H = np.zeros((B, n + 1, m + 1), np.int32)
    E = np.full((B, n + 1, m + 1), NEG32, np.int32)
    F = np.full((B, n + 1, m + 1), NEG32, np.int32)
    go, ge = np.int32(p.gap_open), np.int32(p.gap_extend)
    if mode == "extend":
        H[:, 0, 1:] = NEG32
        H[:, 1:, 0] = NEG32
    elif mode == "fit":
        col = -(go + ge * np.arange(0, n, dtype=np.int32))
        H[:, 1:, 0] = col
        F[:, 1:, 0] = col
    for d in range(2, n + m + 1):
        ilo = max(1, d - m)
        ihi = min(n, d - 1)
        if ilo > ihi:
            continue
        i = np.arange(ilo, ihi + 1)
        j = d - i
        E[:, i, j] = np.maximum(H[:, i, j - 1] - go, E[:, i, j - 1] - ge)
        F[:, i, j] = np.maximum(H[:, i - 1, j] - go, F[:, i - 1, j] - ge)
        s = np.where((q[:, i - 1] == t[:, j - 1]) & (q[:, i - 1] < 4),
                     np.int32(p.match), np.int32(p.mismatch))
        h = np.maximum(H[:, i - 1, j - 1] + s,
                       np.maximum(E[:, i, j], F[:, i, j]))
        if mode == "local":
            h = np.maximum(h, 0)
        H[:, i, j] = h
    return H, E, F


def alignment_stats_batch(q, ql, t, tl, p: SWParams, mode: str,
                          qend, tend, max_bytes: int = 256 << 20):
    """Batched (qstart, tstart, m_sum) for many winning hits.

    Fills DP matrices in size-bounded chunks (<= max_bytes of H+E+F),
    then walks each pair's path from its known endpoint — the walk is
    O(path length), the fill is the cost being amortized.
    Returns int arrays (qstart[B], tstart[B], m_sum[B]).
    """
    q = np.asarray(q)
    t = np.asarray(t)
    B, n = q.shape
    m = t.shape[1]
    qs_out = np.zeros(B, np.int64)
    ts_out = np.zeros(B, np.int64)
    ms_out = np.zeros(B, np.int64)
    per_pair = 3 * 4 * (n + 1) * (m + 1)
    chunk = max(1, int(max_bytes // max(per_pair, 1)))
    for lo in range(0, B, chunk):
        hi = min(B, lo + chunk)
        H, E, F = dp_matrices_batch(q[lo:hi], ql[lo:hi], t[lo:hi],
                                    tl[lo:hi], p, mode)
        for b in range(lo, hi):
            qs, ts, cigar = traceback(
                q[b], t[b], p, mode, int(qend[b]), int(tend[b]),
                mats=(H[b - lo], E[b - lo], F[b - lo]))
            qs_out[b] = qs
            ts_out[b] = ts
            ms_out[b] = sum(ln for op, ln in cigar if op == "M")
    return qs_out, ts_out, ms_out


def traceback(q, t, p: SWParams, mode: str, qend: int, tend: int,
              mats=None):
    """Trace the optimal path ending at (qend, tend).

    Returns (qstart, tstart, cigar) with cigar a list of (op, length),
    op in 'M','I','D' ('I' consumes query, 'D' consumes target —
    BAM convention with q as the read).

    mats: optional precomputed (H, E, F) (e.g. one slice of
    dp_matrices_batch) to skip the per-pair fill.
    """
    H, E, F = dp_matrices(q, t, p, mode) if mats is None else mats
    ops: list[str] = []
    i, j = qend, tend
    state = "H"
    while i > 0 or j > 0:
        if state == "H":
            if mode == "local" and H[i, j] == 0:
                break
            if mode == "overlap" and (i == 0 or j == 0):
                break
            if mode == "fit" and i == 0:
                break
            if i > 0 and j > 0:
                s = p.match if (q[i - 1] == t[j - 1] and q[i - 1] < 4) \
                    else p.mismatch
                if H[i, j] == H[i - 1, j - 1] + s:
                    ops.append("M"); i -= 1; j -= 1
                    continue
            if j > 0 and H[i, j] == E[i, j]:
                state = "E"; continue
            if i > 0 and H[i, j] == F[i, j]:
                state = "F"; continue
            break  # boundary (extend mode origin)
        elif state == "E":
            ops.append("D"); j -= 1
            if not (j > 0 and E[i, j + 1] == E[i, j] - p.gap_extend):
                state = "H"
        else:
            ops.append("I"); i -= 1
            if not (i > 0 and F[i + 1, j] == F[i, j] - p.gap_extend):
                state = "H"
    ops.reverse()
    cigar: list[tuple[str, int]] = []
    for op in ops:
        if cigar and cigar[-1][0] == op:
            cigar[-1] = (op, cigar[-1][1] + 1)
        else:
            cigar.append((op, 1))
    return i, j, cigar


def alignment_stats(q, t, p: SWParams, mode: str, qend: int, tend: int):
    """(qstart, tstart, n_aligned_cols) for the path ending at the
    given cell; n_aligned_cols = total M (match+mismatch) columns, the
    reference's 'map_length' (pick_contigs.py:44-50)."""
    qs, ts, cigar = traceback(q, t, p, mode, qend, tend)
    m_sum = sum(ln for op, ln in cigar if op == "M")
    return qs, ts, m_sum
