"""Scoring parameters and the numpy affine-gap DP oracle.

Exact full-matrix DP, vectorised over anti-diagonals; the tests hold
the batched SW implementations against it.

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


def sw_test_pairs(seed, B=40, Lq=24, Lt=48):
    """Query/target code pairs for holding SW implementations against
    each other: ragged, partly related pairs plus the edge rows 0-6
    (all-N target, all-N query, poly-A ties, one repeated base, a
    length-0 query, a length-0 target and a full-length pair). B >= 7.

    Returns (q int8 [B, Lq], qlen int32 [B], t int8 [B, Lt], tlen)."""
    rng = np.random.default_rng(seed)
    q = rng.integers(0, 4, (B, Lq)).astype(np.int8)
    t = rng.integers(0, 4, (B, Lt)).astype(np.int8)
    ql = rng.integers(1, Lq + 1, B).astype(np.int32)
    tl = rng.integers(1, Lt + 1, B).astype(np.int32)
    for b in range(B):
        k = int(min(ql[b], tl[b]) // 2)
        if k >= 2:
            off = int(rng.integers(0, tl[b] - k + 1))
            chunk = q[b, :k].copy()
            mut = rng.random(k) < 0.1
            chunk[mut] = rng.integers(0, 4, int(mut.sum()))
            t[b, off:off + k] = chunk
    t[0] = 4
    q[1] = 4
    q[2] = 0
    t[2] = 0
    q[3] = q[3, 0]
    t[3] = q[3, 0]
    ql[4] = 0
    tl[5] = 0
    ql[6], tl[6] = Lq, Lt
    return q, ql, t, tl
