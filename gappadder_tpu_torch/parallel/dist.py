"""Gap-home routing over the mesh (counterpart of
gappadder_tpu/parallel/dist.py).

Every shard classifies its slice of the alignment records; the
recruitment entries are then routed to the shard that owns their gap
(gap-home = gap % n_shards), so each gap's whole read set lands on one
shard and the per-gap dedup and assembly stay local afterwards.

The route is the JAX package's dense one: [n_shards, cap]-padded
buckets exchanged by one all-to-all a payload, then a compaction.
Counts are exchanged by an all-gather of each shard's per-destination
send counts (the [src, dst] matrix), from which every shard derives
what it receives. Rows arrive source-major, stable within a source.
With one shard the route is a valid-first stable compaction and no
collective runs. (The JAX package's `ragged` route is TPU-only.)
"""

from __future__ import annotations

import torch


def send_tables(dest, valid, n_shards: int):
    """Per-shard routing tables.

    Args:
      dest: int [cap] destination shard of each local row.
      valid: bool [cap] live-row mask (padding rows are not sent).

    Returns (order, key_sorted, send, in_off):
      order: int64 [cap] stable sort permutation grouping rows by
        destination (invalid rows last);
      key_sorted: int64 [cap] destination of each sorted row (n_shards
        for invalid);
      send: int32 [n_shards] rows bound for each destination;
      in_off: int32 [n_shards] exclusive prefix sums of send."""
    key = torch.where(valid, dest.to(torch.int64),
                      torch.full_like(dest, n_shards, dtype=torch.int64))
    order = torch.sort(key, stable=True).indices
    send = torch.zeros(n_shards, dtype=torch.int32, device=dest.device)
    send.index_add_(0, torch.where(valid, key, torch.zeros_like(key)),
                    valid.to(torch.int32))
    in_off = torch.cumsum(send, 0, dtype=torch.int32) - send
    return order, key[order], send, in_off


def route_shard(payloads, dest, valid, *, out_cap: int, fills, coll=None):
    """Route rows to their destination shard (called inside
    `mesh.shard_map`; `coll` is the shard's `Collectives`, None for
    one shard).

    Args:
      payloads: tuple of tensors sharing the leading [cap] dim.
      dest: int [cap] destination shard per row (unused, and may be
        None, with one shard: every row's home is here).
      valid: bool [cap].
      out_cap: receive capacity a shard. Overflowing rows are dropped
        deterministically from the highest source ranks.
      fills: the padding value of each payload (-1 for the signed
        payloads of the JAX package, 0 for its unsigned ones).

    Returns (routed, src, n_recv): routed tuple of [out_cap, ...] rows
    packed source-major (stable within a source); src int32 [out_cap]
    the source shard of each row (-1 on padding); n_recv int32 [1] the
    raw demand (a value above out_cap means rows were dropped)."""
    if coll is None or coll.n == 1:
        return _route_one(payloads, valid, out_cap, fills)
    N, me = coll.n, coll.me
    cap = dest.shape[0]
    dev = dest.device
    if out_cap > N * cap:
        raise ValueError(
            f"dense route: out_cap={out_cap} exceeds the maximum "
            f"receivable rows n_shards*cap={N * cap}; lower out_cap or "
            "pad the per-shard payload")
    order, key_sorted, send, in_off = send_tables(dest, valid, N)
    mat = coll.all_gather(send)                         # [src, dst]
    # a destination keeps at most out_cap rows, dropped from the
    # highest source ranks: each source's contribution is clamped to
    # the room left after every lower-ranked source
    cum = torch.cumsum(mat, 0, dtype=torch.int32) - mat
    allowed = torch.clamp(torch.minimum(mat, out_cap - cum), min=0)
    recv = allowed[:, me]
    n_recv = mat[:, me].sum().to(torch.int32)[None]
    src_payload = torch.full((cap,), me, dtype=torch.int32, device=dev)

    # bucket slot of each sorted row; the invalid rows (key N) are not
    # written, so every (bucket, slot) written is written once
    live = key_sorted < N
    d_idx = key_sorted[live]
    rank = torch.arange(cap, device=dev)[live] - in_off[d_idx]
    keep = torch.arange(cap, device=dev)[None, :] < recv[:, None]
    order2 = torch.sort((~keep.reshape(-1)).to(torch.uint8),
                        stable=True).indices[:out_cap]
    delivered = torch.arange(out_cap, device=dev) < recv.sum()
    outs = []
    for p, fill in zip((*payloads, src_payload), (*fills, -1)):
        rest = tuple(p.shape[1:])
        buf = torch.full((N, cap) + rest, fill, dtype=p.dtype, device=dev)
        buf[d_idx, rank] = p[order][live]
        got = coll.all_to_all(buf).reshape((N * cap,) + rest)
        res = got[order2]
        outs.append(torch.where(delivered.reshape((-1,) + (1,) * len(rest)),
                                res, torch.full_like(res, fill)))
    return tuple(outs[:-1]), outs[-1], n_recv


def _route_one(payloads, valid, out_cap: int, fills):
    """The one-shard route: the valid rows of each payload to the front,
    in order, into [out_cap, ...], padded with the payload's fill."""
    order = torch.sort((~valid).to(torch.int8), stable=True).indices[:out_cap]
    nv = valid.sum().to(torch.int32)
    live = torch.arange(out_cap, device=valid.device) < torch.clamp(
        nv, max=out_cap)
    outs = []
    for p, fill in zip(payloads, fills):
        res = p[order]
        if res.shape[0] < out_cap:
            pad = torch.full((out_cap - res.shape[0],) + tuple(res.shape[1:]),
                             fill, dtype=p.dtype, device=p.device)
            res = torch.cat([res, pad])
        res = torch.where(live.reshape((-1,) + (1,) * (res.dim() - 1)), res,
                          torch.full_like(res, fill))
        outs.append(res)
    src = torch.where(live, 0, -1).to(torch.int32)
    return tuple(outs), src, nv[None]

