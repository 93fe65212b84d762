"""Batched de-Bruijn unitig assembly over gaps and (k, sub_k) settings
(counterpart of gappadder_tpu/ops/dbg.py::assemble_unitigs_multi, the
one DBG core, and of its one-setting wrapper `assemble_unitigs`).

  nodes  = distinct sub_k-mers of the k-strings and their revcomps
  edges  = distinct (sub_k+1)-mers; edge u->v with u/v its prefix/suffix
  unitig = maximal chain through nodes with outdeg(u) == 1 == indeg(v),
           compacted by pointer doubling, cycles broken at their
           minimum node id
  emit   = the top `max_unitigs` chains by length >= min_len as code
           rows; revcomp twins deduplicated by keeping the
           lexicographically smaller strand (cycle linearisations are
           emitted on their canonical strand instead).

Every function takes a leading axis of lanes, one lane a (setting,
gap) pair (the JAX code vmaps one lane per pair); sub_k is per-lane
data, an int64 tensor [lanes], so settings with different sub_k share
one batch of sorts and gathers. Pointer doubling runs a fixed number
of steps T = bit_length(2N - 1): converged pointers are fixed points,
so the result equals the JAX early-exit loop and needs no host sync.
"""

from __future__ import annotations

import torch

from .. import dna
from ..utils.meters import span, spanned
from . import kmers, psort

FULL = 0xFFFFFFFF
HIST_BUCKETS = 512      # spectrum buckets (shared with parallel/slice.py)


def _arange(n, like):
    return torch.arange(n, device=like.device)


def _gather(x, idx):
    """x[g, idx[g, ...]] for a [G, n] table and [G, ...] indices."""
    return torch.gather(x, 1, idx.reshape(idx.shape[0], -1)).reshape(
        idx.shape)


def _scatter(init, idx, val, reduce=None):
    """Write val [G, n] into init [G, m] at idx along dim 1; `reduce`
    is None (plain set: callers keep indices unique outside a dump
    slot), "sum", "amax" or "amin"."""
    out = init.clone()
    if reduce is None:
        return out.scatter_(1, idx, val)
    if reduce == "sum":
        return out.scatter_add_(1, idx, val)
    return out.scatter_reduce_(1, idx, val, reduce, include_self=True)


def _unique_compact(limbs):
    """Sort [G, P, nl] k-mers, drop duplicates, compact to the front.
    Returns (keys [G, P, nl] sorted unique then FULL, n [G])."""
    s, _ = kmers.sort_kmers(limbs)
    keep = kmers.unique_mask(s) & ~torch.all(s == FULL, dim=-1)
    P = limbs.shape[-2]
    return kmers.compact(s, keep, P, FULL), keep.sum(-1)


def _per_lane(x, like):
    """A per-lane [L] tensor shaped to broadcast against `like` [L, ...]."""
    return x.reshape((-1,) + (1,) * (like.dim() - 1))


def _prefix_masks(edge_limbs, sub_k):
    """[L, 1, ..., nl] masks of the first sub_k bases of each lane's
    nl-limb k-mers; limbs past sub_k are zero."""
    nl = edge_limbs.shape[-1]
    used = (sub_k[:, None] - 16 * _arange(nl, sub_k)).clamp(0, 16)
    masks = (torch.full_like(used, FULL) << (32 - 2 * used)) & kmers.MASK32
    return masks.reshape((-1,) + (1,) * (edge_limbs.dim() - 2) + (nl,))


def _full_where_invalid(edge_limbs, res):
    """res, with FULL on the rows where edge_limbs is all FULL."""
    invalid = torch.all(edge_limbs == FULL, dim=-1, keepdim=True)
    return torch.where(invalid, torch.full_like(res, FULL), res)


def _prefix_kmer_dyn(edge_limbs, sub_k):
    """First sub_k bases of packed (sub_k+1)-mers [L, ..., nl], sub_k a
    per-lane int64 tensor [L]; the limb count stays nl."""
    return _full_where_invalid(edge_limbs,
                               edge_limbs & _prefix_masks(edge_limbs, sub_k))


def _suffix_kmer_dyn(edge_limbs, sub_k):
    """Last sub_k bases of packed (sub_k+1)-mers: shift left one base."""
    nxt = torch.cat([edge_limbs[..., 1:] >> 30,
                     torch.zeros_like(edge_limbs[..., :1])], dim=-1)
    v = ((edge_limbs << 2) & kmers.MASK32) | nxt
    return _full_where_invalid(edge_limbs,
                               v & _prefix_masks(edge_limbs, sub_k))


def _kmer_base(limbs, i: int):
    """Base code at position i of a packed k-mer."""
    l, j = divmod(i, 16)
    return ((limbs[..., l] >> (30 - 2 * j)) & 0x3).to(torch.int8)


def _kmer_base_dyn(limbs, i):
    """Base code at position i of packed k-mers [L, ..., nl], i a
    per-lane int64 tensor [L] with 0 <= i < 16 * nl."""
    limb = torch.gather(limbs, -1, _per_lane(i // 16, limbs).expand(
        limbs.shape[:-1] + (1,)))[..., 0]
    return ((limb >> _per_lane(30 - 2 * (i % 16), limb)) & 0x3).to(
        torch.int8)


def _join_ids_safe(node_keys, query_keys):
    """For each query k-mer, the index of its key in node_keys.

    node_keys: [G, N, nl] sorted unique (FULL padded); query_keys
    [G, Q, nl]. Sort-merge join: nodes tagged 0, queries 1, sorted by
    (key, tag); a cummax carries the last node id forward. FULL queries
    are masked by callers."""
    G, N, nl = node_keys.shape
    Q = query_keys.shape[1]
    dev = node_keys.device
    keys = torch.cat([node_keys, query_keys], dim=1)
    tag = torch.cat([torch.zeros(G, N, dtype=torch.int64, device=dev),
                     torch.ones(G, Q, dtype=torch.int64, device=dev)], 1)
    payload = torch.cat([_arange(N, keys), _arange(Q, keys)]).expand(
        G, N + Q)
    res = psort.bitonic_sort(tuple(keys[..., l] for l in range(nl))
                             + (tag, payload), num_keys=nl + 1)
    stag, spay = res[nl], res[nl + 1]
    nid = torch.where(stag == 0, spay, torch.full_like(spay, -1))
    prop = torch.cummax(nid, dim=-1).values
    tgt = torch.where(stag == 1, spay, torch.full_like(spay, Q))
    out = torch.zeros(G, Q + 1, dtype=torch.int64, device=dev)
    return _scatter(out, tgt, prop)[:, :Q]


def _graph_chains(u_id_raw, v_id_raw, edge_valid, node_valid, N: int,
                  sub_k):
    """Degrees, chain edges, heads, ranks and tails of a [G] batch of
    graphs (sub_k per lane, [G]). Returns the per-graph tensors the
    popping and emission passes need."""
    G = u_id_raw.shape[0]
    dev = u_id_raw.device
    nfill = torch.full_like(u_id_raw, N)
    u_id = torch.where(edge_valid, u_id_raw, nfill)
    v_id = torch.where(edge_valid, v_id_raw, nfill)
    zero = torch.zeros(G, N + 1, dtype=torch.int64, device=dev)
    ones = torch.ones_like(u_id)
    outdeg = _scatter(zero, u_id, ones, "sum")
    indeg = _scatter(zero, v_id, ones, "sum")
    chain = edge_valid & (_gather(outdeg, u_id) == 1) & \
        (_gather(indeg, v_id) == 1)
    # prev[v] = u along chain edges; prev[x] = x elsewhere (chain edges
    # have unique v; every other edge writes N into the dump slot N)
    prev = _scatter(_arange(N + 1, u_id).expand(G, N + 1),
                    torch.where(chain, v_id, nfill),
                    torch.where(chain, u_id, nfill))
    idx = _arange(N, u_id).expand(G, N)
    is_head = (prev[:, :N] == idx) & node_valid

    # pointer doubling: head + min id on the path + hops to the head
    T = max(1, (2 * N - 1).bit_length())
    p = prev[:, :N]
    mn = idx
    off = torch.where(is_head, 0, 1).to(torch.int64)
    for _ in range(T):
        mn = torch.minimum(mn, _gather(mn, p))
        off = off + _gather(off, p)
        p = _gather(p, p)
    reached_head = _gather(is_head, p)
    new_head = is_head | (node_valid & ~reached_head & (mn == idx))

    # cycle fixup: re-rank with the min-id break nodes as heads
    p2 = torch.where(new_head, idx, prev[:, :N])
    off2 = torch.where(new_head, 0, 1).to(torch.int64)
    for _ in range(T):
        off2 = off2 + _gather(off2, p2)
        p2 = _gather(p2, p2)
    off = torch.where(reached_head, off, off2)
    rep = torch.where(reached_head, p, p2)

    nN = torch.full_like(rep, N)
    chain_nodes = _scatter(zero, torch.where(node_valid, rep, nN), off + 1,
                           "amax")
    ulen_all = torch.where(new_head, sub_k[:, None] + chain_nodes[:, :N] - 1,
                           torch.full_like(rep, -1))
    at_tail = node_valid & (off == _gather(chain_nodes, rep) - 1)
    tail_of = _scatter(torch.full_like(zero, -1),
                       torch.where(at_tail, rep, nN), idx)[:, :N]
    return dict(u_id=u_id, v_id=v_id, outdeg=outdeg, indeg=indeg,
                chain=chain, is_head=is_head, new_head=new_head, rep=rep,
                off=off, chain_nodes=chain_nodes, ulen_all=ulen_all,
                tail_of=tail_of)


def _node_coverage(node_keys, occ_keys, occ_valid, occ_w):
    """Coverage of each node: the summed multiplicities of the source
    strings over every occurrence of the node's sub_k-mer."""
    ids = _join_ids_safe(node_keys, occ_keys)
    G, N = node_keys.shape[:2]
    cov = _scatter(torch.zeros(G, N + 1, dtype=torch.int64,
                               device=ids.device),
                   torch.where(occ_valid, ids, torch.full_like(ids, N)),
                   torch.where(occ_valid, occ_w.to(torch.int64),
                               torch.zeros_like(ids)), "sum")
    return cov[:, :N]


def _pop_bubbles_round(g, cov, edge_valid, node_valid, N: int,
                       max_bubble_len):
    """One tour-bus round: delete the lowest-min-coverage branch of
    every simple bubble (two clean chains sharing fork and join), a
    branch at most max_bubble_len [G] long. Returns the updated
    (node_valid, edge_valid)."""
    rep = g["rep"]
    G = rep.shape[0]
    idxN = _arange(N, rep).expand(G, N)
    big = 1 << 30
    nN = torch.full_like(rep, N)
    chaincov = _scatter(torch.full((G, N + 1), big, dtype=torch.int64,
                                   device=rep.device),
                        torch.where(node_valid, rep, nN),
                        torch.where(node_valid, cov,
                                    torch.full_like(cov, big)),
                        "amin")[:, :N]
    m1 = torch.full((G, N + 1), -1, dtype=torch.int64, device=rep.device)
    neg = torch.full_like(g["u_id"], -1)
    in1 = _scatter(m1, g["v_id"], torch.where(edge_valid, g["u_id"], neg),
                   "amax")[:, :N]
    next1 = _scatter(m1, g["u_id"], torch.where(edge_valid, g["v_id"], neg),
                     "amax")[:, :N]

    indeg, outdeg = g["indeg"], g["outdeg"]
    f = in1
    fc = f.clamp(0, N - 1)
    t = g["tail_of"]
    tc = t.clamp(0, N - 1)
    j = _gather(next1, tc)
    cand = (g["is_head"] & node_valid
            & (indeg[:, :N] == 1) & (f >= 0) & (f != idxN)
            & (_gather(outdeg, fc) >= 2)
            & (t >= 0) & (_gather(outdeg, tc) == 1) & (j >= 0)
            & (_gather(indeg, j.clamp(0, N - 1)) >= 2)
            & (g["ulen_all"] <= max_bubble_len[:, None]))

    # group branches by (fork, join); the winner sorts first by
    # (f, j, -min_cov, head id)
    fkey = torch.where(cand, f, torch.full_like(f, N + 1))
    jkey = torch.where(cand, j, torch.full_like(j, N + 1))
    negcov = torch.where(cand, -chaincov, torch.zeros_like(chaincov))
    sf, sj, _, sh = psort.bitonic_sort((fkey, jkey, negcov, idxN),
                                       num_keys=4)
    same = (sf == torch.roll(sf, 1, dims=-1)) & \
        (sj == torch.roll(sj, 1, dims=-1))
    same[:, 0] = False
    loser_sorted = same & (sf <= N)
    loser_head = torch.zeros(G, N + 1, dtype=torch.bool, device=rep.device)
    loser_head = _scatter(loser_head, torch.where(loser_sorted, sh, nN),
                          torch.ones_like(loser_sorted))[:, :N]

    removed = node_valid & _gather(loser_head, rep)
    node_valid = node_valid & ~removed
    removed_p = torch.cat([removed, torch.zeros_like(removed[:, :1])], 1)
    edge_valid = edge_valid & ~_gather(removed_p, g["u_id"]) & \
        ~_gather(removed_p, g["v_id"])
    return node_valid, edge_valid


def _core_lane(occ_keys, sub_k, covdata, *, sub_k_max: int,
               max_unitigs: int, max_len: int, min_len: int,
               pop_bubbles: int, max_bubble_len: int | None, node_cap: int,
               edge_cap: int):
    """DBG build + unitig emission for a [G] batch of lanes, one a
    (setting, gap) pair. occ_keys: [G, Q, nl] (sub_k+1)-mer occurrence
    keys (FULL padded); sub_k: int64 [G], each lane's, at most the
    static sub_k_max; covdata: None or (keys, valid, w) sub_k-mer
    occurrences for bubble-pop coverage."""
    dev = occ_keys.device
    G = occ_keys.shape[0]
    with span("dbg.graph"):
        # ---- edges, then nodes from the edge endpoints -------------------
        edge_keys, n_edges = _unique_compact(occ_keys)
        n_edges_raw = n_edges
        if edge_cap < edge_keys.shape[1]:
            edge_keys = edge_keys[:, :edge_cap]
            n_edges = torch.clamp(n_edges, max=edge_cap)
        E = edge_keys.shape[1]
        edge_valid = _arange(E, edge_keys) < n_edges[:, None]

        u_keys = _prefix_kmer_dyn(edge_keys, sub_k)
        v_keys = _suffix_kmer_dyn(edge_keys, sub_k)
        nl = u_keys.shape[-1]
        q = torch.cat([u_keys, v_keys], dim=1)                # [G, 2E, nl]
        pay = _arange(2 * E, q).expand(G, 2 * E)
        res = psort.bitonic_sort(
            tuple(q[..., l] for l in range(nl)) + (pay,), num_keys=nl)
        sq = torch.stack(res[:nl], dim=-1)
        spay = res[nl]
        firsts = kmers.unique_mask(sq) & ~torch.all(sq == FULL, dim=-1)
        rank = torch.cumsum(firsts.to(torch.int64), dim=-1) - 1
        n_nodes_raw = firsts.sum(-1)

        N = node_cap
        n_nodes = torch.clamp(n_nodes_raw, max=N)
        node_valid = _arange(N, q) < n_nodes[:, None]
        rank_c = rank.clamp(0, N - 1)
        # compacted sorted-unique node keys (first occurrences only)
        node_keys = torch.full((G, N + 1, nl), FULL, dtype=torch.int64,
                               device=dev)
        b = _arange(G, q)[:, None].expand(G, 2 * E)
        node_keys[b, torch.where(firsts & (rank < N), rank_c,
                                 torch.full_like(rank_c, N))] = sq
        node_keys = node_keys[:, :N]
        # endpoint ids back to edge order (spay is a permutation)
        ids = _scatter(
            torch.zeros(G, 2 * E, dtype=torch.int64, device=dev), spay,
            rank_c)
        u_id_raw, v_id_raw = ids[:, :E], ids[:, E:]

    with span("dbg.chains"):
        # ---- bubble popping ----------------------------------------------
        if pop_bubbles > 0:
            cov = _node_coverage(node_keys, *covdata)
            mbl = (2 * (sub_k + 1) if max_bubble_len is None
                   else torch.full_like(sub_k, max_bubble_len))
            for _ in range(pop_bubbles):
                g = _graph_chains(u_id_raw, v_id_raw, edge_valid,
                                  node_valid, N, sub_k)
                node_valid, edge_valid = _pop_bubbles_round(
                    g, cov, edge_valid, node_valid, N, mbl)

        g = _graph_chains(u_id_raw, v_id_raw, edge_valid, node_valid, N,
                          sub_k)
    u_id, v_id = g["u_id"], g["v_id"]
    outdeg, indeg = g["outdeg"], g["indeg"]
    new_head, rep, off = g["new_head"], g["rep"], g["off"]
    ulen_all, tail_of = g["ulen_all"], g["tail_of"]

    with span("dbg.emit"):
        # ---- tip clipping: a short chain dead at one end whose junction
        # has an alternative continuation
        head_dead = indeg[:, :N] == 0
        tailc = tail_of.clamp(0, N - 1)
        tail_dead = torch.where(tail_of >= 0, _gather(outdeg, tailc) == 0,
                                torch.ones_like(head_dead))
        zero = torch.zeros(G, N + 1, dtype=torch.int64, device=dev)
        pred_branch = _scatter(zero, v_id, _gather(outdeg, u_id),
                               "amax")[:, :N] >= 2
        succ_branch = _scatter(zero, u_id, _gather(indeg, v_id),
                               "amax")[:, :N] >= 2
        tip_a = head_dead & ~tail_dead & _gather(succ_branch, tailc) & \
            (tail_of >= 0)
        tip_b = ~head_dead & tail_dead & pred_branch
        is_tip = new_head & (tip_a | tip_b) & \
            (ulen_all < 2 * (sub_k[:, None] + 1))

        U = max_unitigs
        eligible = new_head & (ulen_all >= min_len) & ~is_tip
        sort_key = torch.where(eligible, -ulen_all,
                               torch.ones_like(ulen_all))
        # longest first
        order = torch.sort(sort_key, dim=-1, stable=True).indices
        top = order[:, :U]
        top_ok = _gather(eligible, top)
        uarange = _arange(U, top).expand(G, U)
        uidx_of = _scatter(
            torch.full_like(zero, -1),
            torch.where(top_ok, top, torch.full_like(top, N)),
            torch.where(top_ok, uarange, torch.full_like(top, -1)))

        # ---- materialise sequences ---------------------------------------
        topc = top.clamp(0, N - 1)
        head_keys = torch.gather(node_keys, 1,
                                 topc[..., None].expand(G, U, nl))
        cols = min(sub_k_max, max_len)
        nN = torch.full_like(rep, N)
        # tail bases: node v at offset o >= 1 contributes its last base; a
        # sort by (unitig, offset) makes each unitig's chain one ascending
        # run
        vuid = _gather(uidx_of, torch.where(node_valid, rep, nN))
        lastb = _kmer_base_dyn(node_keys, sub_k - 1)
        w = (vuid >= 0) & (off >= 1) & node_valid
        SHIFT = 1 << 16
        skey = torch.where(w, vuid, torch.full_like(vuid, U)) * SHIFT + \
            torch.where(w, off, torch.zeros_like(off))
        skey_s, lastb_s = psort.bitonic_sort((skey, lastb.to(torch.int64)),
                                             num_keys=1)
        seg_start = torch.searchsorted(skey_s.contiguous(),
                                       (uarange * SHIFT).contiguous())
        pcol = _arange(max_len, top)[None, None, :]
        gidx = seg_start[..., None] + pcol - sub_k[:, None, None]
        ulen_top = _gather(ulen_all, top)
        head_len = torch.clamp(sub_k, max=max_len)[:, None, None]
        tail_ok = (pcol >= head_len) & \
            (pcol < torch.clamp(ulen_top, max=max_len)[..., None]) & \
            top_ok[..., None]
        tails = _gather(lastb_s, gidx.clamp(0, N - 1)).to(torch.int8)
        nfill8 = torch.full_like(tails, dna.N)
        out = torch.where(tail_ok, tails, nfill8)
        if cols:
            prefix = torch.stack(                            # [G, U, cols]
                [_kmer_base(head_keys, i) for i in range(cols)], dim=-1)
            colmask = (pcol[..., :cols] < head_len) & top_ok[..., None]
            out[..., :cols] = torch.where(colmask, prefix, out[..., :cols])
        lens = _scatter(
            torch.zeros(G, U + 1, dtype=torch.int64, device=dev),
            torch.where(top_ok, uarange, torch.full_like(top, U)),
            torch.where(top_ok, torch.clamp(ulen_top, max=max_len),
                        torch.zeros_like(top)))[:, :U]

        # ---- revcomp twin dedup ------------------------------------------
        rcseq = dna.revcomp_t(out, lens)
        diff = out != rcseq
        any_diff = diff.any(-1)
        lpos = _arange(max_len, out)
        fd = torch.where(diff, lpos,
                         torch.full_like(lpos, max_len)).min(-1).values
        fd = torch.where(any_diff, fd, torch.zeros_like(fd))
        a = torch.gather(out, -1, fd[..., None])[..., 0]
        bb = torch.gather(rcseq, -1, fd[..., None])[..., 0]
        # path unitigs keep the lex-smaller strand (their twin is the exact
        # revcomp); cycle unitigs, whose twin breaks at another rotation,
        # are each emitted on their canonical strand
        cyc_head = top_ok & ~_gather(g["is_head"], topc)
        keep = ~any_diff | (a <= bb) | cyc_head
        out = torch.where((cyc_head & any_diff & (bb < a))[..., None], rcseq,
                          out)
        keep = keep & (lens > 0)
        order2 = torch.sort((~keep).to(torch.int8), dim=-1,
                            stable=True).indices
        out = torch.gather(out, 1, order2[..., None].expand(G, U, max_len))
        lens = torch.where(_gather(keep, order2), _gather(lens, order2),
                           torch.zeros_like(lens))
        count = keep.sum(-1)
        out = torch.where((uarange < count[:, None])[..., None], out,
                          torch.full_like(out, dna.N))
        return (out, lens.to(torch.int32), count.to(torch.int32),
                n_nodes_raw.to(torch.int32), n_edges_raw.to(torch.int32))


def _flat_pad(limbs, nl_pad: int, cap: int):
    """[G, ..., nl] -> [G, cap, nl_pad]: extra limbs are zero (FULL on
    invalid rows), which keeps lexicographic order; extra rows FULL."""
    G, nl = limbs.shape[0], limbs.shape[-1]
    flat = limbs.reshape(G, -1, nl)
    if nl < nl_pad:
        inval = torch.all(flat == FULL, dim=-1, keepdim=True)
        tail = torch.where(inval,
                           torch.full_like(inval, FULL, dtype=flat.dtype),
                           torch.zeros_like(inval, dtype=flat.dtype))
        flat = torch.cat([flat] + [tail] * (nl_pad - nl), dim=-1)
    return _pad_rows(flat, cap, FULL)


def _pad_rows(x, cap: int, fill):
    """x [G, X, ...] -> [G, cap, ...], the extra rows `fill`."""
    if x.shape[1] >= cap:
        return x
    pad = torch.full((x.shape[0], cap - x.shape[1]) + tuple(x.shape[2:]),
                     fill, dtype=x.dtype, device=x.device)
    return torch.cat([x, pad], dim=1)


@spanned("dbg.prep")
def _occurrence_prep(kstrings, n_kstrings, kcounts, *, k: int, sub_k: int,
                     nl_pad: int, occ_cap: int, occn_cap: int,
                     pop_bubbles: int):
    """One setting's lanes of a batch: the (sub_k+1)-mer occurrence keys
    [G, occ_cap, nl_pad] of the distinct k-strings + revcomps, and (when
    popping) the sub_k-mer occurrences (keys [G, occn_cap, nl_pad],
    valid, weights) for node coverage. Padded rows are FULL (invalid,
    weight 0)."""
    G, M, kk = kstrings.shape
    assert kk == k and sub_k < k
    row_valid = _arange(M, kstrings) < n_kstrings[:, None]
    fwd = torch.where(row_valid[..., None], kstrings,
                      torch.full_like(kstrings, dna.N))
    rc = dna.revcomp_t(fwd)
    both = torch.cat([fwd, rc], dim=1)                       # [G, 2M, k]
    rv2 = torch.cat([row_valid, row_valid], dim=1)
    blen = torch.where(rv2, k, 0)
    elimb, _ = kmers.extract_kmers(both, blen, sub_k + 1)
    occ = _flat_pad(elimb, nl_pad, occ_cap)

    cov = None
    if pop_bubbles > 0:
        mult = torch.ones_like(row_valid, dtype=torch.int64) \
            if kcounts is None else kcounts.to(torch.int64)
        row_counts = torch.where(row_valid, mult, torch.zeros_like(mult))
        rc2 = torch.cat([row_counts, row_counts], dim=1)     # [G, 2M]
        nlimb, nval = kmers.extract_kmers(both, blen, sub_k)
        P1 = nlimb.shape[2]
        wgt = rc2[:, :, None].expand(G, 2 * M, P1).reshape(G, -1)
        cov = (_flat_pad(nlimb, nl_pad, occn_cap),
               _pad_rows(nval.reshape(G, -1), occn_cap, False),
               _pad_rows(wgt, occn_cap, 0))
    return occ, cov


def _lanes_cat(xs):
    return xs[0] if len(xs) == 1 else torch.cat(xs, dim=0)


def assemble_unitigs_multi(kstr_list, nk_list, kcnt_list, *, settings,
                           max_unitigs: int = 64, max_len: int = 1024,
                           min_len: int = 40, pop_bubbles: int = 0,
                           max_bubble_len: int | None = None,
                           node_cap: int, edge_cap: int):
    """Every (k, sub_k) setting over a gap batch, one lane a (setting,
    gap) pair with its sub_k as per-lane data.

    kstr_list / nk_list / kcnt_list: per setting int8 [G, M_s, k_s] /
    [G] / ([G, M_s] or None); kcnt_list may be None. node_cap/edge_cap:
    uniform caps. Settings group by occurrence rows 2 M_s (k_s - sub_k_s),
    so a (k, k-1) setting is not padded to a (k, k-3) one's rows; each
    group is one batch through `_core_lane`, its keys padded to the
    group's widest limb count. The span `dbg.unitigs` counts the
    settings, the groups (`_core_lane` batches) and the lanes.
    Returns, per setting, (useq int8 [G, U, max_len], ulen int32
    [G, U], count int32 [G], n_nodes_raw, n_edges_raw int32 [G])."""
    G = kstr_list[0].shape[0]
    dev = kstr_list[0].device
    groups: dict[int, list[int]] = {}
    for i, (k, sk) in enumerate(settings):
        groups.setdefault(2 * kstr_list[i].shape[1] * (k - sk),
                          []).append(i)
    results: list = [None] * len(settings)
    with span("dbg.unitigs") as sp:
        sp.add(settings=len(settings), groups=len(groups),
               lanes=len(settings) * G)
        for occ_cap, idxs in sorted(groups.items()):
            sub_set = [settings[i][1] for i in idxs]
            nl_pad = max(kmers.num_limbs(sk + 1) for sk in sub_set)
            occn_cap = max(2 * kstr_list[i].shape[1]
                           * (settings[i][0] - settings[i][1] + 1)
                           for i in idxs)
            preps = [_occurrence_prep(
                kstr_list[i], nk_list[i],
                None if kcnt_list is None else kcnt_list[i],
                k=settings[i][0], sub_k=settings[i][1], nl_pad=nl_pad,
                occ_cap=occ_cap, occn_cap=occn_cap, pop_bubbles=pop_bubbles)
                for i in idxs]
            cov = None if pop_bubbles == 0 else tuple(
                _lanes_cat([p[1][j] for p in preps]) for j in range(3))
            sub_k = _lanes_cat([torch.full((G,), sk, dtype=torch.int64,
                                           device=dev) for sk in sub_set])
            out = _core_lane(_lanes_cat([p[0] for p in preps]), sub_k, cov,
                             sub_k_max=max(sub_set), max_unitigs=max_unitigs,
                             max_len=max_len, min_len=min_len,
                             pop_bubbles=pop_bubbles,
                             max_bubble_len=max_bubble_len, node_cap=node_cap,
                             edge_cap=edge_cap)
            for j, i in enumerate(idxs):
                results[i] = tuple(x[j * G:(j + 1) * G] for x in out)
    return results


def assemble_unitigs(kstrings, n_kstrings, kcounts=None, *, k: int,
                     sub_k: int, max_unitigs: int = 64, max_len: int = 1024,
                     min_len: int = 40, pop_bubbles: int = 0,
                     max_bubble_len: int | None = None,
                     node_cap: int | None = None,
                     edge_cap: int | None = None):
    """Batched over gaps, one (k, sub_k) setting: kstrings int8
    [G, M, k], n_kstrings [G], kcounts optional [G, M]. A thin wrapper
    over `assemble_unitigs_multi` with one setting.

    Returns (useq int8 [G, U, max_len], ulen int32 [G, U], count int32
    [G]); with node_cap/edge_cap given also (n_nodes_raw, n_edges_raw)
    int32 [G] for overflow detection. Without caps, provably sufficient
    bounds are used (2E endpoint rows bound the distinct nodes)."""
    M = kstrings.shape[1]
    capped = node_cap is not None or edge_cap is not None
    ecap = 2 * M * (k - sub_k) if edge_cap is None else edge_cap
    ncap = 2 * ecap if node_cap is None else node_cap
    res = assemble_unitigs_multi(
        (kstrings,), (n_kstrings,), None if kcounts is None else (kcounts,),
        settings=((k, sub_k),), max_unitigs=max_unitigs, max_len=max_len,
        min_len=min_len, pop_bubbles=pop_bubbles,
        max_bubble_len=max_bubble_len, node_cap=ncap, edge_cap=ecap)[0]
    return res if capped else res[:3]


@spanned("kmers.unpack")
def unpack_kmers_to_strings(limbs, k: int):
    """[..., P, nl] packed k-mers -> [..., P, k] int8 codes (FULL -> N)."""
    res = torch.stack([_kmer_base(limbs, i) for i in range(k)], dim=-1)
    invalid = torch.all(limbs == FULL, dim=-1)
    return torch.where(invalid[..., None], torch.full_like(res, dna.N), res)
