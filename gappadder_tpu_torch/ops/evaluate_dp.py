"""The ContigsMerger Evaluate overlap DP on the device (counterpart of
gappadder_tpu/ops/evaluate_dp.py, an XLA function there, torch
operators here).

One batch of contig pairs runs the whole evaluation on `device`: the
matrix fill, the end scan, the winner and the traceback's endpoint
flags, so the host never needs the matrix. The fill is a loop over the
query's rows; each row is the JAX `lax.scan` step: the diagonal and up
moves, then the left move as a running max (`torch.cummax`), and the
endpoint flags carried through the same pointer preference with a
running max of source columns and a gather.

Exactness, as in the JAX module:
  * free start on both sequences (H row/col 0 = 0), linear indels,
    raw character equality (N matches N); the caller pads the query
    with -1 and the target with -2 so padded cells always mismatch;
  * end scan: for c = 0..max_clip, column m-c is scanned BEFORE row
    n-c, candidates improve only on STRICT >, and within a column or row
    the FIRST maximum (lowest row or column) wins;
  * traceback pointer preference: left if left > max(diag, up), else up
    if up > diag, else diagonal.
"""

from __future__ import annotations

import numpy as np
import torch

from .. import entry_device

NEGB = -(1 << 28)


def _first_argmax(x, dim: int):
    """(max, index of its first occurrence) along `dim`."""
    m = x.max(dim=dim, keepdim=True).values
    idx = torch.arange(x.shape[dim], device=x.device)
    shape = [1] * x.dim()
    shape[dim] = -1
    idx = idx.reshape(shape)
    first = torch.where(x == m, idx, x.shape[dim]).min(dim=dim).values
    return m.squeeze(dim), first


def eval_batch_kernel(q, qlen, t, tlen, *, max_clip: int, match: int = 1,
                      mismatch: int = -2, ind: int = -2):
    """Batched Evaluate: returns int32 [6, B] =
    (best, pos_row, pos_col, nclip, ends_i0, ends_j0).

    q [B, n_max] / t [B, m_max] integer codes with DISTINCT padding
    sentinels per side (q padded with -1, t with -2); qlen / tlen valid
    lengths (>= 1). All on one device."""
    B, n_max = q.shape
    m_max = t.shape[1]
    dev = q.device
    i32 = torch.int32
    q = q.to(i32)
    t = t.to(i32)
    qlen = qlen.to(torch.int64)
    tlen = tlen.to(torch.int64)
    jcol = torch.arange(m_max + 1, dtype=i32, device=dev)[None, :]
    indj = ind * jcol

    # the whole matrix and its endpoint flags: bit0 = the traceback from
    # this cell stops on row 0, bit1 = on column 0
    H = torch.empty((B, n_max + 1, m_max + 1), dtype=i32, device=dev)
    E = torch.empty((B, n_max + 1, m_max + 1), dtype=torch.int8, device=dev)
    H[:, 0] = 0
    E[:, 0] = torch.where(jcol == 0, 3, 1).to(torch.int8)
    col0_e = torch.full((B, 1), 2, dtype=torch.int8, device=dev)
    zero_col = torch.zeros((B, 1), dtype=i32, device=dev)
    true_col = torch.ones((B, 1), dtype=torch.bool, device=dev)
    for i in range(n_max):
        prevH, prev_e = H[:, i], E[:, i]
        s = torch.where(t == q[:, i:i + 1], match, mismatch)  # j = 1..m
        d = prevH[:, :-1] + s
        u = prevH[:, 1:] + ind
        c = torch.maximum(d, u)
        # H[i, j] = max(c_j, H[i, j-1] + ind) as a running max
        Hrow = indj + torch.cummax(torch.cat([zero_col, c], 1) - indj,
                                   dim=1).values
        # pointer preference at j >= 1 (left wins only on STRICT >)
        left = (Hrow[:, :-1] + ind) > c
        up = ~left & (u > d)
        base = torch.where(up, prev_e[:, 1:], prev_e[:, :-1])
        base_full = torch.cat([col0_e, base], 1)
        notleft = torch.cat([true_col, ~left], 1)
        src = torch.cummax(torch.where(notleft, jcol, -1), dim=1).values
        H[:, i + 1] = Hrow
        E[:, i + 1] = torch.gather(base_full, 1, src.long())

    C1 = max_clip + 1
    cvec = torch.arange(C1, device=dev)[None, :]
    bi = torch.arange(B, device=dev)
    # column candidates: icol = m - c, best over rows 0..n (first max)
    icol = tlen[:, None] - cvec                                # [B, C1]
    icol_ok = icol >= 0
    icol_c = torch.clamp(icol, 0, m_max)
    colsH = torch.gather(H, 2, icol_c[:, None, :].expand(B, n_max + 1, C1))
    rows_ok = torch.arange(n_max + 1, device=dev)[None, :] <= qlen[:, None]
    colsH = torch.where(rows_ok[:, :, None] & icol_ok[:, None, :], colsH,
                        NEGB)
    col_val, col_pr = _first_argmax(colsH, 1)                  # [B, C1]
    # row candidates: irow = n - c, best over cols 0..m (first max)
    irow = qlen[:, None] - cvec
    irow_ok = irow >= 0
    irow_c = torch.clamp(irow, 0, n_max)
    rowsH = torch.gather(H, 1, irow_c[:, :, None].expand(B, C1, m_max + 1))
    cols_ok = (torch.arange(m_max + 1, device=dev)[None, None, :]
               <= tlen[:, None, None])
    rowsH = torch.where(cols_ok & irow_ok[:, :, None], rowsH, NEGB)
    row_val, row_pc = _first_argmax(rowsH, 2)

    # interleave in the reference scan order: col(c) before row(c), c
    # ascending; strict improvement == first argmax over this order
    vals = torch.stack([col_val, row_val], dim=2).reshape(B, 2 * C1)
    best, w = _first_argmax(vals, 1)
    is_row = (w % 2) == 1
    cwin = w // 2
    pr = torch.where(is_row, irow[bi, cwin], col_pr[bi, cwin])
    pc = torch.where(is_row, row_pc[bi, cwin], icol[bi, cwin])
    eflag = E[bi, pr, pc].to(i32)
    return torch.stack([best.to(i32), pr.to(i32), pc.to(i32), cwin.to(i32),
                        eflag & 1, (eflag >> 1) & 1])


def _bucket(n: int, lo: int) -> int:
    b = lo
    while b < n:
        b *= 2
    return b


# cells a sub-batch may hold: B * (n+1) * (m+1) cells of 5 bytes each
_CELL_BUDGET = 128 << 20


def eval_pairs_device(pairs_seqs, max_clip: int, match: int = 1,
                      mismatch: int = -2, ind: int = -2, device="cuda"):
    """Run a ragged list of (s1, s2) pairs through eval_batch_kernel on
    `device` (the card unless the caller asks for "cpu").

    Returns numpy int32 [len(pairs), 6] rows of
    (best, pos_row, pos_col, nclip, ends_i0, ends_j0). Pairs are grouped
    into (n, m) shape buckets of powers of two, each bucket split to the
    cell budget; one batch and one readback per sub-batch."""
    device = entry_device(device, "eval_pairs_device")
    P = len(pairs_seqs)
    out = np.zeros((P, 6), np.int32)
    if P == 0:
        return out
    groups: dict[tuple[int, int], list[int]] = {}
    for i, (a, b) in enumerate(pairs_seqs):
        key = (_bucket(max(len(a), 1), 64), _bucket(max(len(b), 1), 64))
        groups.setdefault(key, []).append(i)
    for (nb, mb), idxs in sorted(groups.items()):
        cap = max(_CELL_BUDGET // ((nb + 1) * (mb + 1)), 1)
        for lo in range(0, len(idxs), cap):
            sub = idxs[lo:lo + cap]
            Bb = _bucket(len(sub), 8)
            qa = np.full((Bb, nb), -1, np.int32)
            ta = np.full((Bb, mb), -2, np.int32)
            ql = np.ones(Bb, np.int32)
            tl = np.ones(Bb, np.int32)
            for r, i in enumerate(sub):
                a, b = pairs_seqs[i]
                qa[r, :len(a)] = a
                ta[r, :len(b)] = b
                ql[r] = max(len(a), 1)
                tl[r] = max(len(b), 1)
            args = [torch.from_numpy(x).to(device) for x in (qa, ql, ta, tl)]
            with torch.no_grad():
                res = eval_batch_kernel(*args, max_clip=max_clip, match=match,
                                        mismatch=mismatch, ind=ind)
            res = res.cpu().numpy()
            for r, i in enumerate(sub):
                out[i] = res[:, r]
    return out
