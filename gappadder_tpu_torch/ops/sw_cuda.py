"""Batched anti-diagonal affine-gap DP: the CUDA kernel and its plain
PyTorch version.

`sw_batch_cuda` launches the hand-written kernel `csrc/sw.cu`, the
port of gappadder_tpu/ops/sw_pallas.py::sw_batch_pallas. What bounds
it on an H100 is int32 ALU instruction throughput, not bytes: a pair
moves Lq + Lt bytes in and 12 out but needs 11 int32 operations for
each of its Lq x Lt cells. The kernel therefore keeps the DP state in registers
(one thread per query row, one barrier per anti-diagonal), stages the
target once in shared memory and stops each pair at its own last live
diagonal; see the source for the design.

`sw_batch_plain` has exactly the semantics of
gappadder_tpu/ops/sw_xla.py::sw_batch in all four modes (local,
overlap, fit, extend) with `end_slack`, its empty-best fallbacks and
its tie-break (score descending, then diagonal d = i + j ascending,
then row i ascending). The wrapper runs it only for tensors on the CPU.
"""

from __future__ import annotations

import ctypes

import torch

from .sw_host import SWParams

NEG = -(1 << 28)
MODES = {"local": 0, "overlap": 1, "fit": 2, "extend": 3}
MAX_LQ = 1024            # one thread per query row, one block per pair

# kernel launches since the last reset (chip_smoke.py reads this)
launches = 0


def _shift(x, fill):
    """lane i <- lane i-1, lane 0 <- fill ([B] tensor or int)."""
    if not torch.is_tensor(fill):
        fill = torch.full((x.shape[0],), fill, dtype=x.dtype, device=x.device)
    return torch.cat([fill[:, None], x[:, :-1]], dim=1)


def sw_batch_plain(q, qlen, t, tlen, params: SWParams = SWParams(),
                   mode: str = "local", end_slack: int = 0):
    """Batched DP scores + best endpoints, one tensor step per
    anti-diagonal.

    q: int8/int32 [B, Lq] query codes; qlen int32 [B]; t: [B, Lt];
    tlen [B]. Returns int32 (score, qend, tend) [B]; the ends are
    1-based consumed lengths of the best cell."""
    B, Lq = q.shape
    Lt = t.shape[1]
    L = Lq + 1
    dev = q.device
    i32 = torch.int32
    q = q.to(i32)
    t = t.to(i32)
    qlen = qlen.to(i32)
    tlen = tlen.to(i32)
    lane = torch.arange(L, dtype=i32, device=dev)[None, :]
    qreg = torch.cat([torch.full((B, 1), 127, dtype=i32, device=dev), q], 1)
    free_ends = mode in ("local", "overlap")
    go, ge = params.gap_open, params.gap_extend

    def full(v):
        return torch.full((B, L), v, dtype=i32, device=dev)

    def row0(d: int):
        # H[0, j=d]
        if free_ends or mode == "fit":
            return torch.where(d <= tlen, 0, NEG).to(i32)
        return torch.full((B,), 0 if d == 0 else NEG, dtype=i32, device=dev)

    def col0(d: int) -> int:
        # H[i=d, 0]
        if free_ends:
            return 0
        if mode == "fit":
            return -go - (d - 1) * ge
        return NEG

    Hm2 = torch.where(lane == 0, 0, NEG).to(i32).expand(B, L)
    Hm1 = full(NEG)
    Hm1[:, 0] = row0(1)
    if L > 1:
        Hm1[:, 1] = torch.where(1 <= qlen, col0(1), NEG).to(i32)
    Em1 = full(NEG)
    Fm1 = full(NEG)
    tr = full(127)
    if Lt:
        tr[:, 0] = t[:, 0]
    bs = torch.full((B,), NEG, dtype=i32, device=dev)
    bi = torch.zeros(B, dtype=i32, device=dev)
    bd = torch.zeros(B, dtype=i32, device=dev)
    negL = full(NEG)

    for d in range(2, Lq + Lt + 1):
        tchar = t[:, d - 1] if d - 1 < Lt else 127
        tr = _shift(tr, tchar)
        E = torch.maximum(Hm1 - go, Em1 - ge)
        F = torch.maximum(_shift(Hm1, NEG) - go, _shift(Fm1, NEG) - ge)
        s = torch.where((qreg == tr) & (qreg < 4), params.match,
                        params.mismatch).to(i32)
        H = torch.maximum(_shift(Hm2, NEG) + s, torch.maximum(E, F))
        if mode == "local":
            H = torch.clamp(H, min=0)
        j = d - lane
        valid = (lane >= 1) & (lane <= qlen[:, None]) & \
            (j >= 1) & (j <= tlen[:, None])
        H = torch.where(valid, H, negL)
        E = torch.where(valid, E, negL)
        F = torch.where(valid, F, negL)
        H = torch.where(lane == 0, row0(d)[:, None], H)
        col0_ok = (lane == d) & (lane <= qlen[:, None])
        H = torch.where(col0_ok, torch.full_like(H, col0(d)), H)

        if mode == "overlap":
            endcell = valid & ((lane >= qlen[:, None] - end_slack) |
                               (j >= tlen[:, None] - end_slack))
        elif mode == "fit":
            endcell = valid & (lane == qlen[:, None])
        else:
            endcell = valid
        cand = torch.where(endcell, H, negL)
        m = cand.max(dim=1).values
        am = torch.where(cand == m[:, None], lane,
                         torch.full_like(lane, L)).min(dim=1).values
        upd = m > bs
        bs = torch.where(upd, m, bs)
        bi = torch.where(upd, am, bi)
        bd = torch.where(upd, torch.full_like(bd, d), bd)
        Hm2, Hm1, Em1, Fm1 = Hm1, H, E, F

    score = bs
    if mode == "fit":
        # the all-gap cell H[qlen, 0]
        fb = -(go + (qlen - 1) * ge)
        empty = score < fb
        score = torch.where(empty, fb, score)
        bi = torch.where(empty, qlen, bi)
        bd = torch.where(empty, qlen, bd)
    else:
        # local / extend: the empty alignment at the origin; overlap:
        # the zero-score boundary cell H[qlen, 0]
        empty = score < 0
        fbq = qlen if mode == "overlap" else torch.zeros_like(qlen)
        score = torch.where(empty, 0, score).to(i32)
        bi = torch.where(empty, fbq, bi)
        bd = torch.where(empty, fbq, bd)
    return score, bi, bd - bi


def sw_batch_cuda(q, qlen, t, tlen, params: SWParams = SWParams(),
                  mode: str = "local", end_slack: int = 0):
    """Same contract as `sw_batch_plain`. CPU tensors take the plain
    version; CUDA tensors launch `csrc/sw.cu` (int8 codes, int32
    lengths, contiguous, Lq <= 1024) or raise."""
    global launches
    tensors = (q, qlen, t, tlen)
    if all(x.device.type == "cpu" for x in tensors):
        return sw_batch_plain(q, qlen, t, tlen, params, mode, end_slack)
    dev = q.device
    if dev.type != "cuda" or any(x.device != dev for x in tensors):
        raise ValueError("sw_batch_cuda: all inputs must be on one CUDA "
                         f"device, got {[str(x.device) for x in tensors]}")
    if q.dtype != torch.int8 or t.dtype != torch.int8:
        raise TypeError("sw_batch_cuda: q and t must be int8 codes")
    if qlen.dtype != torch.int32 or tlen.dtype != torch.int32:
        raise TypeError("sw_batch_cuda: qlen and tlen must be int32")
    if q.dim() != 2 or t.dim() != 2 or q.shape[0] != t.shape[0] \
            or qlen.shape != (q.shape[0],) or tlen.shape != (q.shape[0],):
        raise ValueError("sw_batch_cuda: expected q [B, Lq], t [B, Lt], "
                         "qlen/tlen [B]")
    if not all(x.is_contiguous() for x in tensors):
        raise ValueError("sw_batch_cuda: inputs must be contiguous")
    if q.shape[1] > MAX_LQ:
        raise ValueError(f"sw_batch_cuda: Lq={q.shape[1]} > {MAX_LQ}")
    if mode not in MODES:
        raise ValueError(f"sw_batch_cuda: unknown mode {mode!r}")

    from . import cuda_build
    lib = cuda_build.load("sw")
    fn = lib.sw_batch_launch
    vp, ci = ctypes.c_void_p, ctypes.c_int
    fn.argtypes = [vp, vp, vp, vp] + [ci] * 9 + [vp, vp, vp, vp]
    fn.restype = ci
    B, Lq = q.shape
    Lt = t.shape[1]
    out = [torch.empty(B, dtype=torch.int32, device=dev) for _ in range(3)]
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = fn(q.data_ptr(), qlen.data_ptr(), t.data_ptr(), tlen.data_ptr(),
                 B, Lq, Lt, params.match, params.mismatch, params.gap_open,
                 params.gap_extend, MODES[mode], end_slack,
                 out[0].data_ptr(), out[1].data_ptr(), out[2].data_ptr(),
                 stream)
    if err != 0:
        raise RuntimeError(f"sw_batch_cuda: kernel launch failed "
                           f"(cudaError {err})")
    launches += 1
    return tuple(out)
