"""Gap-home routing on one device (counterpart of the single-shard path
of gappadder_tpu/parallel/dist.py::route_shard).

With one shard every row's home is this device, so routing is a
valid-first stable compaction into `out_cap` rows. The multi-device
all-to-all forms belong to a later slice of the port.
"""

from __future__ import annotations

import torch


def route_shard(payloads, valid, *, out_cap: int, fills):
    """Compact the valid rows of each payload to the front, in order,
    into [out_cap, ...]. Padding is `fills[i]` for payload i. The JAX
    form's `dest` is dropped: with one shard every row's home is here.

    Returns (routed, src, n_recv): src int32 [out_cap] is 0 on delivered
    rows and -1 on padding; n_recv int32 [1] is the raw demand (a value
    above out_cap means rows were dropped)."""
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
