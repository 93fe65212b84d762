"""The ContigsMerger Evaluate overlap DP on the device (counterpart of
gappadder_tpu/ops/evaluate_dp.py, an XLA `lax.scan` there).

One call evaluates a ragged batch of contig pairs: the matrix fill, the
end scan, the winner and the traceback's endpoint flags, so the host
never needs the matrix. `eval_pairs_device` packs the pairs ragged,
longest first (`pack_pairs`), and
  * on the card launches the hand-written kernel `csrc/evaluate.cu`
    once for the whole pack: a warp a pair, a band of query rows a lane
    held in registers, the columns swept as an anti-diagonal wavefront,
    queries past 1024 rows in strips; no matrix in device memory. Its
    bound is int32 issue, about 12 operations a live cell (see the
    source for the design). It raises rather than fall back;
  * on the CPU pads the pack into the batches of `eval_batch_kernel`,
    the plain version: a loop over the query's rows, each row the JAX
    `lax.scan` step (the diagonal and up moves, the left move as a
    running max, `torch.cummax`, and the endpoint flags carried through
    the same pointer preference with a running max of source columns
    and a gather).
Both give their results in the pack's order, scattered back to the
callers'.

Exactness, as in the JAX module:
  * free start on both sequences (H row/col 0 = 0), linear indels,
    raw character equality (N matches N); an empty sequence is one
    sentinel code, and `eval_batch_kernel` pads the query with -1 and
    the target with -2 so padded cells always mismatch;
  * end scan: for c = 0..max_clip, column m-c is scanned BEFORE row
    n-c, candidates improve only on STRICT >, and within a column or row
    the FIRST maximum (lowest row or column) wins;
  * traceback pointer preference: left if left > max(diag, up), else up
    if up > diag, else diagonal.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from .. import entry_device
from . import cuda_build

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


# cells a CPU sub-batch may hold: B * (n+1) * (m+1) cells of 5 bytes each
_CELL_BUDGET = 128 << 20

# kernel launches since the last reset (chip_smoke.py reads this)
launches = 0

STRIP_ROWS = 1024   # csrc/evaluate.cu sweeps longer queries in strips
# evaluate_launch's arguments before the stream (cuda_build.CTYPES codes)
ARGS = "piiiiipp"
# the codes an empty query or target is packed as: one code that equals
# no other (eval_batch_kernel's padding sentinels)
Q_EMPTY, T_EMPTY = -1, -2


@dataclasses.dataclass
class Pack:
    """A ragged batch of pairs in the order they are evaluated, longest
    first (n * m descending): `order[k]` is the caller's index of packed
    pair k. `meta` int32 [P, 5] holds each pair's (query offset, n,
    target offset, m, scratch offset or -1) into `codes` (int8, every
    pair's query then target) and into the strips' scratch, a row of
    `col_ints` int32 a column for each pair of more than `strip_rows`
    query rows (`scratch_len` in all; see `pack_pairs`)."""
    order: np.ndarray
    meta: np.ndarray
    codes: np.ndarray
    scratch_len: int

    def pair(self, k: int):
        """Packed pair k's (query, target) codes."""
        qo, n, to, m, _ = (int(x) for x in self.meta[k])
        return self.codes[qo:qo + n], self.codes[to:to + m]

    def buffer(self) -> np.ndarray:
        """The bytes csrc/evaluate.cu reads: `meta`, then `codes`."""
        return np.concatenate([self.meta.view(np.int8).ravel(), self.codes])


def pack_pairs(pairs_seqs, strip_rows: int = STRIP_ROWS, col_ints: int = 1,
               sentinels: bool = True) -> Pack:
    """The ragged pack of (s1, s2) pairs for a kernel that sweeps queries
    of more than `strip_rows` rows in strips through a scratch row of
    `col_ints` int32 a column (csrc/evaluate.cu's defaults). With
    `sentinels` an empty sequence becomes one sentinel code (Q_EMPTY,
    T_EMPTY) that matches nothing; without, it stays empty."""
    P = len(pairs_seqs)
    seqs = []
    for a, b in pairs_seqs:
        seqs.append(np.asarray(a, np.int8) if len(a) or not sentinels else
                    np.array([Q_EMPTY], np.int8))
        seqs.append(np.asarray(b, np.int8) if len(b) or not sentinels else
                    np.array([T_EMPTY], np.int8))
    lens = np.fromiter((len(x) for x in seqs), np.int64, 2 * P).reshape(P, 2)
    order = np.argsort(-(lens[:, 0] * lens[:, 1]), kind="stable")
    lens = lens[order]
    flat = lens.ravel()
    offs = np.concatenate([[0], np.cumsum(flat)[:-1]]).reshape(P, 2)
    strips = lens[:, 0] > strip_rows
    s_len = np.where(strips, lens[:, 1] * col_ints, 0)
    s_off = np.where(strips, np.cumsum(s_len) - s_len, -1)
    total = int(flat.sum())
    if total >= 1 << 31 or int(s_len.sum()) >= 1 << 31:
        raise ValueError("eval_pairs_device: a batch of 2 G codes or more")
    meta = np.stack([offs[:, 0], lens[:, 0], offs[:, 1], lens[:, 1], s_off],
                    1).astype(np.int32)
    codes = np.concatenate([seqs[2 * i + w] for i in order for w in (0, 1)])
    return Pack(order, meta, codes, int(s_len.sum()))


def eval_pack_plain(pack: Pack, device, **kw) -> np.ndarray:
    """Packed results [P, 6] by eval_batch_kernel on `device` (the CPU):
    the pack's pairs padded into (n, m) power-of-two buckets, each
    bucket split to the cell budget."""
    P = len(pack.order)
    out = np.zeros((P, 6), np.int32)
    groups: dict[tuple[int, int], list[int]] = {}
    for k in range(P):
        key = (_bucket(int(pack.meta[k, 1]), 64),
               _bucket(int(pack.meta[k, 3]), 64))
        groups.setdefault(key, []).append(k)
    for (nb, mb), idxs in sorted(groups.items()):
        cap = max(_CELL_BUDGET // ((nb + 1) * (mb + 1)), 1)
        for lo in range(0, len(idxs), cap):
            sub = idxs[lo:lo + cap]
            Bb = _bucket(len(sub), 8)
            qa = np.full((Bb, nb), -1, np.int32)
            ta = np.full((Bb, mb), -2, np.int32)
            ql = np.ones(Bb, np.int32)
            tl = np.ones(Bb, np.int32)
            for r, k in enumerate(sub):
                a, b = pack.pair(k)
                qa[r, :len(a)] = a
                ta[r, :len(b)] = b
                ql[r] = len(a)
                tl[r] = len(b)
            args = [torch.from_numpy(x).to(device) for x in (qa, ql, ta, tl)]
            with torch.no_grad():
                res = eval_batch_kernel(*args, **kw)
            out[sub] = res.cpu().numpy().T[:len(sub)]
    return out


def eval_pack_cuda(pack: Pack, device, **kw) -> np.ndarray:
    """Packed results [P, 6] by csrc/evaluate.cu: one copy of the pack
    to the card, one launch, one readback."""
    # built and loaded before the pack reaches the card
    cuda_build.bind("evaluate", "evaluate_launch", ARGS)
    P = len(pack.order)
    dbuf = torch.from_numpy(pack.buffer()).to(device)
    out = torch.empty((P, 6), dtype=torch.int32, device=device)
    scratch = (torch.empty(pack.scratch_len, dtype=torch.int32, device=device)
               if pack.scratch_len else None)
    launch(dbuf, P, out, scratch, **kw)
    return out.cpu().numpy()


def launch(dbuf, P: int, out, scratch, *, max_clip: int, match: int,
           mismatch: int, ind: int) -> None:
    """One launch of csrc/evaluate.cu on the current stream: `dbuf` a
    pack's `buffer()` on the card, `out` int32 [P, 6], `scratch` int32
    [scratch_len] (None where no pair takes strips)."""
    global launches
    cuda_build.launch(cuda_build.bind("evaluate", "evaluate_launch", ARGS),
                      dbuf.get_device(), dbuf.data_ptr(), P, max_clip,
                      match, mismatch, ind, out.data_ptr(),
                      None if scratch is None else scratch.data_ptr())
    launches += 1


def eval_pairs_device(pairs_seqs, max_clip: int, match: int = 1,
                      mismatch: int = -2, ind: int = -2, device="cuda"):
    """Evaluate a ragged list of (s1, s2) pairs on `device` (the card
    unless the caller asks for "cpu").

    Returns numpy int32 [len(pairs), 6] rows of
    (best, pos_row, pos_col, nclip, ends_i0, ends_j0), in the callers'
    order. The pairs are packed ragged, longest first (`pack_pairs`); on
    the card the pack is one launch of csrc/evaluate.cu (or it raises),
    on the CPU it is padded into eval_batch_kernel's batches. Either way
    the results come back in the pack's order and are scattered back."""
    device = entry_device(device, "eval_pairs_device")
    P = len(pairs_seqs)
    out = np.zeros((P, 6), np.int32)
    if P == 0:
        return out
    pack = pack_pairs(pairs_seqs)
    kw = dict(max_clip=max_clip, match=match, mismatch=mismatch, ind=ind)
    run = eval_pack_cuda if device.type == "cuda" else eval_pack_plain
    out[pack.order] = run(pack, device, **kw)
    return out
