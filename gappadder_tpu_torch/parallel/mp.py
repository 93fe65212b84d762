"""Multi-process (multi-GPU) execution helpers (counterpart of
gappadder_tpu/parallel/mp.py).

The pipeline runs SPMD across processes through torch.distributed:
every process runs the same host program over the same global values;
the device stages shard records and gap batches over the mesh
(`parallel/mesh.py`), whose shards are laid out process-major (process
p of P holds shards [p*M, (p+1)*M)); host stages (merge, pick, rescue)
compute the same bytes on every process; files are written by process
0 alone, with barriers at the stage boundaries so later stages read
them.

Which device a process drives: on the card, `cuda:(rank %
device_count)`, one shard; on the CPU, `set_cpu_devices(M)` (the CLI's
`--cpu-devices M`) gives M CPU shards a process, as the JAX package's
`jax_num_cpu_devices` does.

The collectives' backend is chosen by a rule, never by trial
(`backend_for`): gloo for CPU shards; NCCL when each rank has a card
of its own; gloo when ranks share a card (NCCL refuses two ranks on one
device). Barriers and the host gathers of `to_np` always go over a
gloo group. gloo takes CUDA tensors for all_to_all_single, all_gather
and all_reduce in the torch the port runs with (checked on the H100),
so no collective is staged through host memory.

Initialization: cli.py --coordinator/--num-processes/--process-id (or
the GAPPADDER_DIST_* environment variables) -> init_distributed().
"""

from __future__ import annotations

import datetime
import socket

import numpy as np
import torch
import torch.distributed as tdist

# seconds a rank waits for the others to join, and then for any one
# collective or barrier, before it fails
DEFAULT_TIMEOUT_S = 300.0

# process-wide settings, the counterpart of JAX's global config: the
# CPU shards a process holds, and the collectives' group (set by
# init_distributed; barriers and host gathers go over the default
# group, which is gloo)
_state = {"cpu_devices": 1, "group": None}


def process_count() -> int:
    if tdist.is_available() and tdist.is_initialized():
        return tdist.get_world_size()
    return 1


def process_index() -> int:
    if tdist.is_available() and tdist.is_initialized():
        return tdist.get_rank()
    return 0


def is_primary() -> bool:
    """Rank 0 of torch.distributed when it is initialised, else True."""
    return process_index() == 0


def set_cpu_devices(n: int) -> int:
    """CPU shards a process holds (default 1); returns the old count.
    The counterpart of `jax_num_cpu_devices`: set it before the mesh is
    made."""
    if n < 1:
        raise ValueError(f"set_cpu_devices: need at least 1, got {n}")
    old = _state["cpu_devices"]
    _state["cpu_devices"] = int(n)
    return old


def local_devices(device="cuda") -> list[torch.device]:
    """This process's devices, one a shard: `set_cpu_devices`' count of
    CPU shards for a CPU device, else the card of this rank,
    cuda:(rank % device_count)."""
    device = torch.device(device)
    if device.type == "cpu":
        return [torch.device("cpu")] * _state["cpu_devices"]
    if not torch.cuda.is_available():
        raise RuntimeError("local_devices: no CUDA device is available; "
                           "pass device='cpu' to run on the CPU")
    return [torch.device("cuda", process_index() % torch.cuda.device_count())]


def backend_for(cpu_devices: int, cards_shared: bool) -> str:
    """The collectives' backend by the rule of the module docstring:
    gloo on CPU shards and when ranks share a card, else NCCL."""
    return "gloo" if cpu_devices > 0 or cards_shared else "nccl"


def init_distributed(coordinator: str, num_processes: int, process_id: int,
                     local_cpu_devices: int = 0,
                     timeout_s: float = DEFAULT_TIMEOUT_S) -> str:
    """Join the run's process group at `coordinator` (HOST:PORT, process
    0 listens there) as rank `process_id` of `num_processes`.

    local_cpu_devices > 0 gives this process that many CPU shards and
    gloo collectives (the CPU test path); 0 drives the card
    cuda:(rank % device_count). The process group itself is gloo (the
    barriers' and host gathers' group); on cards that no two ranks
    share, the collectives get an NCCL group of their own. A rank that
    the others never join, or a collective or barrier that a peer never
    enters, fails after `timeout_s`. Returns the collectives' backend."""
    if not 0 <= process_id < num_processes:
        raise ValueError(f"init_distributed: process id {process_id} is "
                         f"not in [0, {num_processes})")
    if local_cpu_devices:
        set_cpu_devices(local_cpu_devices)
    timeout = datetime.timedelta(seconds=timeout_s)
    tdist.init_process_group("gloo", init_method=f"tcp://{coordinator}",
                             world_size=num_processes, rank=process_id,
                             timeout=timeout)
    shared = False
    if not local_cpu_devices:
        card = local_devices()[0]
        torch.cuda.set_device(card)
        keys = [None] * num_processes
        tdist.all_gather_object(keys, (socket.gethostname(), card.index))
        shared = len(set(keys)) < num_processes
    name = backend_for(local_cpu_devices, shared)
    _state["group"] = (tdist.new_group(backend="nccl", timeout=timeout)
                       if name == "nccl" else tdist.group.WORLD)
    return name


def barrier(tag: str) -> None:
    """Cross-process sync point over the gloo group (no-op with one
    process). `tag` names the point for a reader of a hang."""
    del tag
    if process_count() > 1:
        tdist.barrier()


# ---- collectives across processes (the second stage of mesh.py's) -----

def _wire(x):
    """Bool tensors travel as uint8 (the backends take no bool)."""
    return x.to(torch.uint8) if x.dtype == torch.bool else x


def all_reduce(x, op: str):
    """Sum or max of `x` over the processes (a new tensor)."""
    y = _wire(x).clone()
    tdist.all_reduce(y, op=tdist.ReduceOp.SUM if op == "sum"
                     else tdist.ReduceOp.MAX, group=_state["group"])
    return y.to(x.dtype)


def all_gather(x, group=None):
    """[P, ...]: every process's `x`, in process order (over the
    collectives' group unless `group` is given)."""
    y = _wire(x).contiguous()
    parts = [torch.empty_like(y) for _ in range(process_count())]
    tdist.all_gather(parts, y, group=group or _state["group"])
    return torch.stack(parts).to(x.dtype)


def all_to_all(x):
    """`x` [P, ...]: row q goes to process q; returns [P, ...] with row
    q from process q (all_to_all_single, equal splits in process
    order)."""
    y = _wire(x).contiguous()
    out = torch.empty_like(y)
    tdist.all_to_all_single(out, y, group=_state["group"])
    return out.to(x.dtype)


# ---- global arrays on the host ------------------------------------------

def to_np(x) -> np.ndarray:
    """Global numpy view of a `mesh.ShardedArray`: a replicated array's
    copy, or every shard's piece in global shard order (this process's
    pieces, then, when its mesh spans processes, gathered over the gloo
    group)."""
    if not x.split:
        return x.pieces[0].cpu().numpy()
    local = torch.cat([p.cpu() for p in x.pieces])
    if x.mesh.process_count > 1:
        local = all_gather(local, group=tdist.group.WORLD).reshape(
            (-1,) + tuple(local.shape[1:]))
    return local.numpy()

