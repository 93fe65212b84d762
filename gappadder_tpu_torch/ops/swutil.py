"""Shape-bucketed dispatch for the SW kernel (counterpart of
gappadder_tpu/ops/swutil.py).

Every alignment batch (pick, merge, rescue, Evaluate, the tools) goes
through here: batch size and sequence lengths are padded up to the
same power-of-two buckets as in the JAX package (`sw_pairs`,
`sw_ragged`), or, for a few pairs against long targets, only to the
pairs' own lengths (`sw_small`), and the batch runs through
`sw_cuda.sw_batch_cuda` on `device` — the hand-written kernel on the
card, its plain version only when the caller asks for the CPU. Results
come back as numpy, as the JAX functions return them.
"""

from __future__ import annotations

import numpy as np
import torch

from .. import dna, entry_device
from .sw_cuda import sw_batch_cuda
from .sw_host import SWParams


def _bucket(n: int, lo: int) -> int:
    b = lo
    while b < n:
        b *= 2
    return b


def sw_pairs(queries, qlens, targets, tlens, params: SWParams,
             mode: str, end_slack: int = 0, device="cuda"):
    """Aligned scores for padded arrays with shape bucketing.

    queries [B, Lq] int8, targets [B, Lt] int8 (+ lens). Returns
    numpy int32 (score, qend, tend) of length B."""
    device = entry_device(device, "sw_pairs")
    B, Lq = queries.shape
    Lt = targets.shape[1]
    Bb = _bucket(max(B, 1), 64)
    Lqb = _bucket(max(Lq, 1), 64)
    Ltb = _bucket(max(Lt, 1), 128)
    qp = np.full((Bb, Lqb), dna.N, np.int8)
    tp = np.full((Bb, Ltb), dna.N, np.int8)
    qp[:B, :Lq] = queries
    tp[:B, :Lt] = targets
    qlp = np.zeros(Bb, np.int32)
    tlp = np.zeros(Bb, np.int32)
    qlp[:B] = qlens
    tlp[:B] = tlens
    args = [torch.from_numpy(x).to(device) for x in (qp, qlp, tp, tlp)]
    with torch.no_grad():
        s, qe, te = sw_batch_cuda(*args, params, mode, end_slack)
        out = torch.stack([s, qe, te]).cpu().numpy()
    return out[0, :B], out[1, :B], out[2, :B]


def sw_small(queries, targets, params: SWParams, mode: str,
             end_slack: int = 0, device="cuda"):
    """A few pairs (lists of code arrays) in one kernel call, padded only
    to the longest query and target (at least 8 codes, as the JAX
    package pads its lone pairs), not to sw_pairs' buckets: a lone query
    against a whole scaffold would otherwise pay for 64 pairs of strip
    scratch. Returns numpy int32 (score, qend, tend)."""
    device = entry_device(device, "sw_small")
    B = len(queries)
    qa = np.full((B, max(max(len(q) for q in queries), 8)), dna.N, np.int8)
    ta = np.full((B, max(max(len(t) for t in targets), 8)), dna.N, np.int8)
    for i, (q, t) in enumerate(zip(queries, targets)):
        qa[i, :len(q)] = q
        ta[i, :len(t)] = t
    ql = np.array([len(q) for q in queries], np.int32)
    tl = np.array([len(t) for t in targets], np.int32)
    args = [torch.from_numpy(x).to(device) for x in (qa, ql, ta, tl)]
    with torch.no_grad():
        out = torch.stack(sw_batch_cuda(*args, params, mode, end_slack))
    out = out.cpu().numpy()
    return out[0], out[1], out[2]


def sw_ragged(queries, targets, params: SWParams, mode: str,
              end_slack: int = 0, device="cuda"):
    """Ragged list-of-arrays wrapper over sw_pairs, grouping pairs by
    query-length bucket so short pairs don't pay for the longest one."""
    if not queries:
        z = np.zeros(0, np.int64)
        return z, z, z
    B = len(queries)
    out_s = np.zeros(B, np.int64)
    out_qe = np.zeros(B, np.int64)
    out_te = np.zeros(B, np.int64)
    groups: dict[int, list[int]] = {}
    for i, q in enumerate(queries):
        groups.setdefault(_bucket(max(len(q), 1), 64), []).append(i)
    for _, idxs in sorted(groups.items()):
        Lq = max(len(queries[i]) for i in idxs)
        Lt = max(len(targets[i]) for i in idxs)
        qa = np.full((len(idxs), max(Lq, 1)), dna.N, np.int8)
        ta = np.full((len(idxs), max(Lt, 1)), dna.N, np.int8)
        ql = np.zeros(len(idxs), np.int32)
        tl = np.zeros(len(idxs), np.int32)
        for r, i in enumerate(idxs):
            q, t = queries[i], targets[i]
            qa[r, :len(q)] = q
            ta[r, :len(t)] = t
            ql[r] = len(q)
            tl[r] = len(t)
        s, qe, te = sw_pairs(qa, ql, ta, tl, params, mode, end_slack,
                             device)
        out_s[idxs] = s
        out_qe[idxs] = qe
        out_te[idxs] = te
    return out_s, out_qe, out_te
