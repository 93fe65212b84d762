"""Local Smith-Waterman with affine gaps, batched over pairs in plain
PyTorch, one tensor step an anti-diagonal: a frozen copy of the port's
plain twin `sw_batch_plain` in local mode (BWA's scoring: match 1,
mismatch -4, a gap's first base 7, each further base 1). Returns the
best score and its end in query and target (1-based consumed lengths),
ties broken to the least anti-diagonal i + j and then the least row i.
Nothing here imports the program.

`band` restricts the DP to cells with |i - j| <= band: the banded
alignment that the control puts in the program's place.
"""

from __future__ import annotations

import torch

NEG = -(1 << 28)
MATCH, MISMATCH, GAP_OPEN, GAP_EXTEND = 1, -4, 7, 1


def _shift(x, fill):
    """lane i <- lane i-1, lane 0 <- fill ([B] tensor or int)."""
    head = fill[:, None].to(x.dtype) if torch.is_tensor(fill) \
        else torch.full_like(x[:, :1], fill)
    return torch.cat([head, x[:, :-1]], dim=1)


def local_sw(q, qlen, t, tlen, band: int | None = None):
    """q int8 [B, Lq] codes, qlen [B], t [B, Lt], tlen [B]. Returns int32
    (score, qend, tend) [B]."""
    B, Lq = q.shape
    Lt = t.shape[1]
    L = Lq + 1
    dev = q.device
    i32 = torch.int32
    q, t = q.to(i32), t.to(i32)
    qlen, tlen = qlen.to(i32), tlen.to(i32)
    lane = torch.arange(L, dtype=i32, device=dev)[None, :]
    qreg = torch.cat([torch.full((B, 1), 127, dtype=i32, device=dev), q], 1)
    go, ge = GAP_OPEN, GAP_EXTEND
    negL = torch.full((B, L), NEG, dtype=i32, device=dev)

    def row0(d: int):
        return torch.where(d <= tlen, 0, NEG).to(i32)

    Hm2 = torch.where(lane == 0, 0, NEG).to(i32).expand(B, L)
    Hm1 = negL.clone()
    Hm1[:, 0] = row0(1)
    if L > 1:
        Hm1[:, 1] = torch.where(1 <= qlen, 0, NEG).to(i32)
    Em1, Fm1 = negL.clone(), negL.clone()
    tr = torch.full((B, L), 127, dtype=i32, device=dev)
    if Lt:
        tr[:, 0] = t[:, 0]
    bs = torch.full((B,), NEG, dtype=i32, device=dev)
    bi = torch.zeros(B, dtype=i32, device=dev)
    bd = torch.zeros(B, dtype=i32, device=dev)
    for d in range(2, Lq + Lt + 1):
        tr = _shift(tr, t[:, d - 1] if d - 1 < Lt else 127)
        E = torch.maximum(Hm1 - go, Em1 - ge)
        F = torch.maximum(_shift(Hm1, NEG) - go, _shift(Fm1, NEG) - ge)
        s = torch.where((qreg == tr) & (qreg < 4), MATCH, MISMATCH).to(i32)
        H = torch.clamp(torch.maximum(_shift(Hm2, NEG) + s,
                                      torch.maximum(E, F)), min=0)
        j = d - lane
        valid = (lane >= 1) & (lane <= qlen[:, None]) & \
            (j >= 1) & (j <= tlen[:, None])
        if band is not None:
            valid = valid & ((lane - j).abs() <= band)
        H = torch.where(valid, H, negL)
        E = torch.where(valid, E, negL)
        F = torch.where(valid, F, negL)
        H = torch.where(lane == 0, row0(d)[:, None], H)
        H = torch.where((lane == d) & (lane <= qlen[:, None]),
                        torch.zeros_like(H), H)
        cand = torch.where(valid, H, negL)
        m = cand.max(dim=1).values
        am = torch.where(cand == m[:, None], lane,
                         torch.full_like(lane, L)).min(dim=1).values
        upd = m > bs
        bs = torch.where(upd, m, bs)
        bi = torch.where(upd, am, bi)
        bd = torch.where(upd, torch.full_like(bd, d), bd)
        Hm2, Hm1, Em1, Fm1 = Hm1, H, E, F
    empty = bs < 0
    score = torch.where(empty, 0, bs).to(i32)
    bi = torch.where(empty, torch.zeros_like(bi), bi)
    bd = torch.where(empty, torch.zeros_like(bd), bd)
    return score, bi, bd - bi
