"""Device mesh, placement and the SPMD runner of the port (counterpart of
gappadder_tpu/parallel/mesh.py and of the `jax.shard_map` its steps run
under).

A mesh has n_shards = prod(shape) shards, its axes flattened as one
data-parallel axis (`dp`), as the JAX steps flatten them. Process p of
P holds the M shards [p*M, (p+1)*M) (process-major, the order of
`jax.devices()` across processes), each on a device of its own or
several on one (an explicit device list may repeat a card). Arrays are
placed split along the leading dim over the shards (`dp_sharding`) or
as a copy on each (`replicated`). The one-device run is a mesh too:
`local_mesh(device)`, one shard of this process alone, whose shard runs
in the calling thread and whose collectives return their input.

`shard_map(fn, mesh, in_specs, out_specs)` runs fn once a shard, with
the shard's pieces and a `Collectives` giving its index and the mesh's
collectives. Collectives run in two stages: among this process's own
shards, in the process; then across processes through torch.distributed
(`mp.all_reduce`, `mp.all_gather`, `mp.all_to_all`). A process's shards
run in turn, one at a time, each in its own thread: a shard runs until
its next collective, hands the turn on, and the last one to arrive
performs the collective, so every step runs its shards in shard order
and no two of them issue work at once.
"""

from __future__ import annotations

import dataclasses
import threading

import numpy as np
import torch

from . import mp

DP = "dp"      # split along the leading dim over the shards
REP = "rep"    # a copy on every shard


@dataclasses.dataclass(frozen=True)
class Mesh:
    """`shape` and `axis_names` as the JAX mesh's; `devices` are this
    process's shards' devices in shard order (process p holds shards
    [p*M, (p+1)*M), M = len(devices))."""
    shape: tuple[int, ...]
    axis_names: tuple[str, ...]
    devices: tuple[torch.device, ...]
    process_count: int = 1
    process_index: int = 0

    @property
    def n_shards(self) -> int:
        return self.process_count * len(self.devices)

    @property
    def first_shard(self) -> int:
        return self.process_index * len(self.devices)


@dataclasses.dataclass(frozen=True)
class Sharding:
    mesh: Mesh
    spec: str                 # DP or REP


@dataclasses.dataclass(frozen=True)
class ShardedArray:
    """A global array over `mesh` as this process holds it: one piece a
    local shard, in shard order; `split` pieces are consecutive blocks
    of the leading dim, else copies."""
    pieces: tuple[torch.Tensor, ...]
    split: bool
    mesh: Mesh


def make_mesh(shape=None, axes=("dp", "sp"), devices=None) -> Mesh:
    """A mesh over this process's `devices` (default: the card of this
    rank, `mp.local_devices()`) and the same count on every other
    process. shape=None favours dp, with sp a factor of 2 where the
    shard count is even, as the JAX make_mesh does."""
    devices = tuple(torch.device(d) for d in (
        devices if devices is not None else mp.local_devices()))
    P = mp.process_count()
    n = P * len(devices)
    if shape is None:
        sp = 2 if n % 2 == 0 and n > 1 else 1
        shape = (n // sp, sp)
    shape = tuple(int(s) for s in shape)
    if int(np.prod(shape)) != n or len(axes) != len(shape):
        raise ValueError(f"make_mesh: shape {shape} over axes {axes} does "
                         f"not hold {P} process(es) x {len(devices)} "
                         "device(s)")
    return Mesh(shape, tuple(axes), devices, P, mp.process_index())


def local_mesh(device) -> Mesh:
    """The one-device run as a mesh: one shard on `device`, of this
    process alone (no collective crosses processes, whatever their
    count)."""
    return Mesh((1,), (DP,), (torch.device(device),))


def make_mesh_if_configured(cfg, device) -> Mesh:
    """The mesh of `cfg.tpu.mesh_shape` over the processes' shards
    (processes x `mp.local_devices(device)`, an equal share a process),
    or `local_mesh(device)` when it has one shard or the processes hold
    fewer shards than it asks for: the unsharded run, as the JAX
    package's `pipeline/run.py::_make_mesh_if_configured` falls back
    with fewer devices."""
    n_mesh = int(np.prod(cfg.tpu.mesh_shape, dtype=np.int64))
    if n_mesh <= 1:
        return local_mesh(device)
    local = mp.local_devices(device)
    P = mp.process_count()
    if P * len(local) < n_mesh:
        return local_mesh(device)
    if n_mesh % P:
        raise ValueError(f"tpu.mesh_shape {tuple(cfg.tpu.mesh_shape)} does "
                         f"not split over {P} processes")
    return make_mesh(devices=local[:n_mesh // P])


def dp_sharding(mesh: Mesh) -> Sharding:
    return Sharding(mesh, DP)


def replicated(mesh: Mesh) -> Sharding:
    return Sharding(mesh, REP)


def as_tensor(a) -> torch.Tensor:
    """A tensor of `a` (numpy uint32, the name hashes, becomes int64
    holding the same values; a tensor stays as it is)."""
    if torch.is_tensor(a):
        return a
    a = np.asarray(a)
    # astype copies: the tensor owns writable memory of its own
    return torch.from_numpy(a.astype(np.int64 if a.dtype == np.uint32
                                     else a.dtype))


def place(arr, sharding: Sharding) -> ShardedArray:
    """This process's pieces of the global value `arr` (numpy or a
    tensor; every process passes the same): its shards' blocks of the
    leading dim for DP, a copy on each of its shards for REP."""
    if isinstance(arr, ShardedArray):
        return arr
    mesh = sharding.mesh
    t = as_tensor(arr)
    if sharding.spec == REP:
        return ShardedArray(tuple(t.to(d) for d in mesh.devices), False,
                            mesh)
    N = mesh.n_shards
    if t.shape[0] % N:
        raise ValueError(f"place: leading dim {t.shape[0]} is not a "
                         f"multiple of the {N} shards")
    b = t.shape[0] // N
    s0 = mesh.first_shard
    return ShardedArray(tuple(t[(s0 + j) * b:(s0 + j + 1) * b].to(d)
                              for j, d in enumerate(mesh.devices)), True,
                        mesh)


# ---------------------------------------------------------------------------
# collectives: this process's shards first, then across processes
# ---------------------------------------------------------------------------

def _reduce(mesh: Mesh, xs, op: str):
    hub, acc = xs[0].device, xs[0]
    for x in xs[1:]:
        acc = acc + x.to(hub) if op == "sum" else torch.maximum(acc, x.to(hub))
    if mesh.process_count > 1:
        acc = mp.all_reduce(acc, op)
    return [acc.to(x.device) for x in xs]


def _all_gather(mesh: Mesh, xs):
    local = torch.stack([x.to(xs[0].device) for x in xs])   # [M, ...]
    if mesh.process_count > 1:
        local = mp.all_gather(local).reshape((-1,) + tuple(local.shape[1:]))
    return [local.to(x.device) for x in xs]


def _all_to_all(mesh: Mesh, xs):
    """xs[j] is [N, ...]: row d goes to shard d. Returns, for each local
    shard d, [N, ...] with row s from shard s."""
    M, P = len(xs), mesh.process_count
    local = torch.stack([x.to(xs[0].device) for x in xs])   # [M src, N dst]
    rest = tuple(local.shape[2:])
    if P == 1:
        return [local[:, d].to(x.device) for d, x in enumerate(xs)]
    # [P dst proc, M src, M dst, ...]: process q's block, then the swap
    blocks = local.reshape((M, P, M) + rest).transpose(0, 1)
    got = mp.all_to_all(blocks)                        # [P src proc, ...]
    return [got[:, :, d].reshape((P * M,) + rest).to(x.device)
            for d, x in enumerate(xs)]


class _Turns:
    """The rendezvous of one process's shards: shard j runs only while
    it holds the turn; at a collective it leaves its value and hands the
    turn to j + 1, and the last shard combines every value."""

    def __init__(self, m: int):
        self.m, self.turn = m, 0
        self.cv = threading.Condition()
        self.slots: list = [None] * m
        self.results: list = []
        self.error: BaseException | None = None

    def _wait(self, j):
        self.cv.wait_for(lambda: self.turn == j or self.error is not None)
        if self.error is not None:
            raise _Aborted

    def start(self, j):
        with self.cv:
            self._wait(j)

    def exchange(self, j, value, combine):
        with self.cv:
            self.slots[j] = value
            if j == self.m - 1:
                self.results = combine(list(self.slots))
            self.turn = (j + 1) % self.m
            self.cv.notify_all()
            self._wait(j)
            return self.results[j]

    def finish(self, j):
        with self.cv:
            self.turn = j + 1
            self.cv.notify_all()

    def fail(self, err):
        with self.cv:
            if self.error is None:
                self.error = err
            self.cv.notify_all()


class _Aborted(Exception):
    """Another shard of this process failed."""


class Collectives:
    """One shard's view of the mesh inside `shard_map`: its global index
    `me`, the shard count `n`, and the collectives over every shard."""

    def __init__(self, mesh: Mesh, local: int, turns: _Turns | None):
        self.mesh, self.local, self.turns = mesh, local, turns
        self.me = mesh.first_shard + local
        self.n = mesh.n_shards

    def _exchange(self, x, combine):
        if self.turns is None:
            return combine([x])[0]
        return self.turns.exchange(self.local, x, combine)

    def psum(self, x):
        return self._exchange(x, lambda xs: _reduce(self.mesh, xs, "sum"))

    def pmax(self, x):
        return self._exchange(x, lambda xs: _reduce(self.mesh, xs, "max"))

    def all_gather(self, x):
        """[n, ...]: every shard's x in shard order."""
        return self._exchange(x, lambda xs: _all_gather(self.mesh, xs))

    def all_to_all(self, x):
        """x [n, ...], row d for shard d; returns [n, ...], row s from
        shard s."""
        return self._exchange(x, lambda xs: _all_to_all(self.mesh, xs))


def _run_shards(mesh: Mesh, fn, per_shard):
    """fn(*args, coll=...) for each local shard; returns their results
    in shard order. One shard runs in the calling thread."""
    M = len(mesh.devices)
    if M == 1:
        with torch.no_grad():
            return [fn(*per_shard[0], coll=Collectives(mesh, 0, None))]
    turns = _Turns(M)
    outs: list = [None] * M

    def work(j):
        try:
            turns.start(j)
            with torch.no_grad():
                outs[j] = fn(*per_shard[j], coll=Collectives(mesh, j, turns))
            turns.finish(j)
        except _Aborted:
            pass
        except BaseException as err:       # handed to the caller below
            turns.fail(err)

    threads = [threading.Thread(target=work, args=(j,), daemon=True)
               for j in range(M)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    if turns.error is not None:
        raise turns.error
    return outs


def map_blocks(mesh: Mesh, fn, *arrays):
    """fn(*blocks, device=d) on each of this process's shards' blocks of
    the leading dim of the numpy `arrays`, in turn (fn runs no
    collective); fn returns a tuple of numpy arrays. Returns each of
    them over every shard, concatenated in shard order (gathered across
    processes): the global result, split over the mesh and gathered."""
    N = mesh.n_shards
    if arrays[0].shape[0] % N:
        raise ValueError(f"map_blocks: leading dim {arrays[0].shape[0]} is "
                         f"not a multiple of the {N} shards")
    b = arrays[0].shape[0] // N
    s0 = mesh.first_shard
    outs = [fn(*(a[(s0 + j) * b:(s0 + j + 1) * b] for a in arrays), device=d)
            for j, d in enumerate(mesh.devices)]
    return tuple(mp.to_np(ShardedArray(tuple(
        torch.from_numpy(np.ascontiguousarray(o[i])) for o in outs), True,
        mesh))
        for i in range(len(outs[0])))


def shard_map(fn, mesh: Mesh, in_specs, out_specs):
    """fn run SPMD over the mesh: the returned callable takes global
    values or ShardedArrays (placed by `in_specs`, DP or REP each) and
    returns ShardedArrays (`out_specs`: DP outputs are each shard's
    piece, [n_shards * piece, ...] in shard order as a global array;
    REP outputs the same value on every shard). fn is called as
    fn(*pieces, coll=Collectives) and returns a tuple of tensors."""
    def run(*args):
        placed = [place(a, Sharding(mesh, s)) for a, s in zip(args, in_specs)]
        outs = _run_shards(mesh, fn, [tuple(a.pieces[j] for a in placed)
                                      for j in range(len(mesh.devices))])
        return tuple(ShardedArray(tuple(o[i] for o in outs), s == DP, mesh)
                     for i, s in enumerate(out_specs))
    return run
