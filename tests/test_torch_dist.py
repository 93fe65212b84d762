"""Port parity of gap-home routing over a mesh: `gappadder_tpu_torch`'s
`send_tables` and dense `route_shard` (run by `mesh.shard_map` over N
CPU shards) against the JAX package's under `shard_map` on N virtual CPU
devices, array for array, at N = 2, 4 and 8: random, empty, skewed and
overflowing demands, and the out_cap ValueError. Then the mesh's own
collectives and its shard runner (turns, failure, a stress run with
more shards than cores)."""

import sys
import threading

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from gappadder_tpu.parallel import dist as jdist
from gappadder_tpu.parallel.mesh import make_mesh as jmake_mesh
from gappadder_tpu_torch.parallel import dist as tdist
from gappadder_tpu_torch.parallel import mesh as tmesh
from gappadder_tpu_torch.parallel import mp

from test_torch_run_scenarios import one_torch_thread  # noqa: F401


def _cpu_mesh(n):
    return tmesh.make_mesh(shape=(n,), axes=("dp",), devices=["cpu"] * n)


def _router(mesh, n_payloads, *, out_cap, fills):
    """`route_shard` over `mesh`, as the JAX `make_router` runs it: fn(
    payloads, dest, valid) on global values split along the leading
    dim, returning (routed, src, n_recv) as ShardedArrays."""
    def shard(*args, coll):
        routed, src, n_recv = tdist.route_shard(
            args[:n_payloads], args[-2], args[-1], out_cap=out_cap,
            fills=fills, coll=coll)
        return (*routed, src, n_recv)
    run = tmesh.shard_map(shard, mesh, (tmesh.DP,) * (n_payloads + 2),
                          (tmesh.DP,) * (n_payloads + 2))

    def fn(payloads, dest, valid):
        out = run(*payloads, dest, valid)
        return out[:n_payloads], out[-2], out[-1]
    return fn


def _scenario(name, N, cap, rng):
    """dest, valid [N, cap] of a named demand pattern."""
    if name == "random":
        return (rng.integers(0, N, (N, cap)).astype(np.int32),
                rng.random((N, cap)) < 0.7)
    if name == "empty":
        return np.zeros((N, cap), np.int32), np.zeros((N, cap), bool)
    if name == "skewed":                # one source sends all to N - 1
        valid = np.zeros((N, cap), bool)
        valid[1] = True
        return np.full((N, cap), N - 1, np.int32), valid
    if name == "overflow":              # every row to shard 0
        return np.zeros((N, cap), np.int32), np.ones((N, cap), bool)
    raise ValueError(name)


def _both_routes(N, cap, out_cap, dest, valid, pays):
    """The JAX dense router and the port's on the same global inputs;
    returns (jax arrays, port arrays) of (payloads..., src, n_recv)."""
    jm = jmake_mesh(shape=(N,), axes=("dp",), devices=jax.devices()[:N])
    jr = jdist.make_router(jm, n_payloads=len(pays), out_cap=out_cap,
                           impl="dense")
    flat = [p.reshape((N * cap,) + p.shape[2:]) for p in pays]
    (jp, jsrc, jn) = jr(tuple(jdist.place_dp(jm, p) for p in flat),
                        jdist.place_dp(jm, dest.reshape(-1)),
                        jdist.place_dp(jm, valid.reshape(-1)))
    want = [np.asarray(x) for x in (*jp, jsrc, jn)]
    fills = [0 if p.dtype.kind == "u" else -1 for p in pays]
    tr = _router(_cpu_mesh(N), len(pays), out_cap=out_cap, fills=fills)
    tp, tsrc, tn = tr(tuple(flat), dest.reshape(-1), valid.reshape(-1))
    got = [mp.to_np(x) for x in (*tp, tsrc, tn)]
    return want, got


@pytest.mark.parametrize("N", [2, 4, 8])
@pytest.mark.parametrize("name", ["random", "empty", "skewed", "overflow"])
def test_route_matches_jax(N, name):
    rng = np.random.default_rng(N)
    cap, L = 16, 5
    out_cap = 12 if name == "overflow" else N * cap
    dest, valid = _scenario(name, N, cap, rng)
    pays = (rng.integers(0, 1 << 30, (N, cap)).astype(np.int32),
            rng.integers(0, 4, (N, cap, L)).astype(np.int8),
            rng.integers(0, 1 << 32, (N, cap), dtype=np.uint64).astype(
                np.uint32))
    want, got = _both_routes(N, cap, out_cap, dest, valid, pays)
    for i, (w, g) in enumerate(zip(want, got)):
        assert w.shape == g.shape, i
        np.testing.assert_array_equal(w, g, err_msg=str(i))
    n_recv = got[-1]
    if name == "overflow":
        # raw demand: every row of every source, though out_cap arrive,
        # and the rows kept are the lowest sources' (highest dropped)
        assert n_recv[0] == N * cap and (n_recv[1:] == 0).all()
        assert (got[-2][:out_cap] == 0).all()
        np.testing.assert_array_equal(got[0][:out_cap],
                                      pays[0].reshape(-1)[:out_cap])
    else:
        assert n_recv.sum() == valid.sum()


def test_route_one_shard_is_a_compaction():
    rng = np.random.default_rng(3)
    valid = rng.random(32) < 0.5
    pay = torch.arange(32, dtype=torch.int32)
    (r,), src, n = tdist.route_shard(
        (pay,), torch.zeros(32, dtype=torch.int32), torch.from_numpy(valid),
        out_cap=40, fills=(-1,))
    nv = int(valid.sum())
    assert int(n[0]) == nv
    np.testing.assert_array_equal(r[:nv].numpy(), np.flatnonzero(valid))
    assert (r[nv:] == -1).all() and (src[:nv] == 0).all() and \
        (src[nv:] == -1).all()


def test_route_out_cap_above_receivable_raises():
    N, cap = 2, 4
    tr = _router(_cpu_mesh(N), 1, out_cap=N * cap + 1, fills=(-1,))
    with pytest.raises(ValueError, match="exceeds the maximum"):
        tr((np.zeros(N * cap, np.int32),), np.zeros(N * cap, np.int32),
           np.ones(N * cap, bool))


@pytest.mark.parametrize("N", [3, 8])
def test_send_tables_match_jax(N):
    rng = np.random.default_rng(N)
    dest = rng.integers(0, N, 40).astype(np.int32)
    valid = rng.random(40) < 0.6
    want = jdist.send_tables(jnp.asarray(dest), jnp.asarray(valid), N)
    got = tdist.send_tables(torch.from_numpy(dest), torch.from_numpy(valid),
                            N)
    for w, g in zip(want, got):
        np.testing.assert_array_equal(np.asarray(w), g.numpy())


def test_mesh_layout_is_process_major():
    """Process p of P holds shards [p*M, (p+1)*M) and its blocks of a
    split array, the order of jax.devices() across the JAX 2-process
    worker's processes (scripts/mp_slice_worker.py: 2 x 4 devices)."""
    P, M = 2, 4
    arr = np.arange(P * M * 3).reshape(P * M, 3)
    blocks = []
    for p in range(P):
        mesh = tmesh.Mesh((P * M,), ("dp",), (torch.device("cpu"),) * M,
                          process_count=P, process_index=p)
        assert mesh.n_shards == P * M and mesh.first_shard == p * M
        got = tmesh.place(arr, tmesh.dp_sharding(mesh))
        blocks += [b.numpy() for b in got.pieces]
        rep = tmesh.place(arr, tmesh.replicated(mesh))
        assert all(np.array_equal(r.numpy(), arr) for r in rep.pieces)
    # each process's pieces, process after process, are the global rows
    # in shard order; JAX places device d's block d the same way
    np.testing.assert_array_equal(np.concatenate(blocks), arr)
    jm = jmake_mesh(shape=(P * M,), axes=("dp",), devices=jax.devices())
    placed = jdist.place_dp(jm, arr)
    for s, dev in enumerate(jax.devices()):
        shard = [x for x in placed.addressable_shards if x.device == dev][0]
        np.testing.assert_array_equal(np.asarray(shard.data), blocks[s])


def test_collectives_in_shard_order():
    N = 4
    mesh = _cpu_mesh(N)

    def fn(x, *, coll):
        me = torch.tensor([coll.me])
        rows = torch.arange(N) * 10 + coll.me          # row d for shard d
        return (coll.psum(x), coll.pmax(x), coll.all_gather(me)[:, 0],
                coll.all_to_all(rows))
    run = tmesh.shard_map(fn, mesh, (tmesh.DP,), (tmesh.REP, tmesh.REP,
                                                  tmesh.DP, tmesh.DP))
    s, m, g, a = run(np.array([1, 5, 2, 7], np.int64))
    assert mp.to_np(s).tolist() == [15] and mp.to_np(m).tolist() == [7]
    assert mp.to_np(g).tolist() == list(range(N)) * N
    # shard d receives row d of every source s, which is d*10 + s
    assert mp.to_np(a).reshape(N, N).tolist() == [
        [d * 10 + s for s in range(N)] for d in range(N)]


def test_shard_failure_raises_and_stops_every_shard():
    mesh = _cpu_mesh(4)
    done = []

    def fn(x, *, coll):
        if coll.me == 2:
            raise RuntimeError("shard 2 failed")
        y = coll.psum(x)
        done.append(coll.me)
        return (y,)
    run = tmesh.shard_map(fn, mesh, (tmesh.DP,), (tmesh.REP,))
    before = threading.active_count()
    with pytest.raises(RuntimeError, match="shard 2 failed"):
        run(np.arange(4))
    assert done == [] and threading.active_count() == before


def test_turns_stress_more_shards_than_cores():
    """32 shards in one process, each through 20 collectives, with a
    tiny switch interval: every result is exact (a lost update or two
    shards at once would break the sums or the order log)."""
    N, rounds = 32, 20
    mesh = _cpu_mesh(N)
    log = []

    def fn(x, *, coll):
        acc = x
        for r in range(rounds):
            log.append(coll.me)
            acc = coll.psum(acc) % 1000003 + coll.me
        return (acc,)
    run = tmesh.shard_map(fn, mesh, (tmesh.DP,), (tmesh.DP,))
    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        out = mp.to_np(run(np.arange(N, dtype=np.int64))[0])
    finally:
        sys.setswitchinterval(old)
    want = np.arange(N, dtype=np.int64)
    for _ in range(rounds):
        want = want.sum() % 1000003 + np.arange(N)
    np.testing.assert_array_equal(out, want)
    assert log == list(range(N)) * rounds
