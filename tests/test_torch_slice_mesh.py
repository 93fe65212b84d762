"""Port parity of the step and the Assembly batch over a mesh:
`gappadder_tpu_torch`'s `make_slice_step` on N CPU shards against the
JAX `make_slice_step` under `shard_map` on N virtual CPU devices, all 12
outputs in their raw sharded layout, at (N, Gl) = (1, 8), (2, 4), (4, 2)
and (8, 1); the mesh-shape invariance of tests/test_slice.py; and the
fused Assembly batch at N = 2 and 4 against the JAX batch on the same
mesh and the port's one-device batch."""

import dataclasses

import numpy as np
import pytest
import jax

from gappadder_tpu.config import Config as JConfig, TpuParams
from gappadder_tpu.parallel import slice as jsl
from gappadder_tpu.parallel.mesh import make_mesh as jmake_mesh
from gappadder_tpu.pipeline import fused as jfused
from gappadder_tpu_torch.config import Config
from gappadder_tpu_torch.parallel import mesh as tmesh
from gappadder_tpu_torch.parallel import mp
from gappadder_tpu_torch.parallel import slice as tsl
from gappadder_tpu_torch.parallel.mp_slice_worker import summarize
from gappadder_tpu_torch.pipeline import fused, run

from test_torch_run_scenarios import one_torch_thread  # noqa: F401
from test_torch_slice import NAMES

SHAPES = [(1, 8), (2, 4), (4, 2), (8, 1)]


def _cpu_mesh(n):
    return tmesh.make_mesh(shape=(n,), axes=("dp",), devices=["cpu"] * n)


def _port_step(n, gl, **kw):
    dims, args = tsl.example_data(n, gaps_per_shard=gl, **kw)
    mesh = _cpu_mesh(n)
    out = tsl.make_slice_step(mesh, dims)(*tsl.place_args(mesh, args))
    return dims, [mp.to_np(o) for o in out]


@pytest.mark.parametrize("n,gl", SHAPES)
def test_sharded_step_matches_jax(n, gl):
    jd, args = jsl.example_data(n, gaps_per_shard=gl, use_pallas=False)
    jm = jmake_mesh(shape=(n,), axes=("dp",), devices=jax.devices()[:n])
    want = [np.asarray(o) for o in
            jsl.make_slice_step(jm, jd)(*jsl.place_args(jm, args))]
    td = tsl.dims_from_fields(dataclasses.asdict(jd))
    mesh = _cpu_mesh(n)
    got = [mp.to_np(o) for o in
           tsl.make_slice_step(mesh, td)(*tsl.place_args(mesh, args))]
    assert len(got) == 12
    for nm, w, g in zip(NAMES, want, got):
        assert w.dtype == g.dtype and w.shape == g.shape, nm
        np.testing.assert_array_equal(w, g, err_msg=nm)
    tsl.check_overflow(td, got[0])


@pytest.mark.parametrize("n,gl", SHAPES)
def test_sharded_step_mesh_shape_invariance(n, gl):
    """The 8-gap scenario on every mesh shape: identical per-gap reads,
    contigs and scores and identical summed outputs; counts[7], the
    largest router demand of a shard, grows as shards get fewer."""
    base = summarize(*_port_step(8, 1))
    got = summarize(*_port_step(n, gl))
    assert got["counts"][:7] == base["counts"][:7]
    assert got["counts"][7] * n >= base["counts"][7]
    assert got["hist"] == base["hist"]
    assert got["total_recv"] == base["total_recv"]
    assert got["per_gap"] == base["per_gap"]


def test_sharded_step_rows_follow_home_of():
    """Row shard * Gl + slot of the 4-shard step is gap shard + slot * N
    of the one-device step, array for array."""
    dims, args = tsl.example_data(4, gaps_per_shard=2, gap_len=(64, 160))
    one = [o.numpy() for o in tsl.run_step(
        dataclasses.replace(dims, n_shards=1, gaps_per_shard=8,
                            entry_cap=4 * dims.entry_cap), args,
        device="cpu")]
    _, four = _port_step(4, 2, gap_len=(64, 160))
    shard, slot = tsl.home_of(np.arange(dims.n_gaps), 4)
    rows = shard * 2 + slot
    for nm, a, b in list(zip(NAMES, one, four))[3:]:
        np.testing.assert_array_equal(a, b[rows], err_msg=nm)


def test_step_dims_must_match_the_mesh():
    dims, args = tsl.example_data(4, gaps_per_shard=1)
    mesh = _cpu_mesh(4)
    with pytest.raises(ValueError, match="2 shards, the mesh 4"):
        tsl.make_slice_step(mesh, dataclasses.replace(dims, n_shards=2))(
            *tsl.place_args(mesh, args))
    with pytest.raises(ValueError, match="4 shards, the mesh 1"):
        tsl.run_step(dims, args, device="cpu")


def _batch(kset, data_kw, N):
    dims, args = tsl.example_data(1, kset=kset, **data_kw)
    rowtab = tsl.run_step(dims, args, device="cpu")[4].numpy()
    readsets, per_gap, _ = tsl.example_reads(args, rowtab)
    R, md = run._bucket_of(max(len(p) for p in per_gap))
    G = dims.n_gaps
    batch = list(range(G)) + [-1] * (-(-(G + 1) // N) * N - G)
    return batch, per_gap, readsets, R, args[22].shape[1], md


@pytest.mark.parametrize("name,N", [("skewed_two_settings", 2),
                                    ("skewed_two_settings", 4),
                                    ("caps_grow", 4)])
def test_sharded_assemble_batch_matches_jax(name, N):
    kset, data_kw, cfg_kw, md = {
        "skewed_two_settings": (((17, 15), (21, 19)),
                                dict(gaps_per_shard=3, gap_len=(64, 160)),
                                {}, None),
        "caps_grow": (((17, 15),), dict(gaps_per_shard=2, gap_len=480),
                      dict(max_unitigs=1), 256)}[name]
    batch, per_gap, readsets, R, L, md0 = _batch(kset, data_kw, N)
    md = md or md0
    kw = dict(draft_genome="draft.fa", kmers=kset, **cfg_kw)
    jm = jmake_mesh(shape=(N,), axes=("dp",), devices=jax.devices()[:N])
    want = jfused.assemble_batch(JConfig(**kw, tpu=TpuParams(
        use_pallas=False)), jm, batch, per_gap, readsets, R, L, md)
    got = fused.assemble_batch(Config(**kw), batch, per_gap, readsets, R, L,
                               md, device="cpu", mesh=_cpu_mesh(N))
    one = fused.assemble_batch(Config(**kw), batch, per_gap, readsets, R, L,
                               md, device="cpu")
    for f in ("seq", "length", "count"):
        g, w = getattr(got, f), np.asarray(getattr(want, f))
        assert g.dtype == w.dtype and g.shape == w.shape, f
        np.testing.assert_array_equal(g, w, err_msg=f)
        np.testing.assert_array_equal(g, getattr(one, f), err_msg=f)
    assert got.names == want.names == one.names


def test_sharded_assemble_batch_needs_a_multiple_of_the_shards():
    batch, per_gap, readsets, R, L, md = _batch(((17, 15),),
                                                dict(gaps_per_shard=3), 1)
    with pytest.raises(ValueError, match="do not split over 4 shards"):
        fused.assemble_batch(Config(draft_genome="d.fa"), batch[:3],
                             per_gap, readsets, R, L, md, device="cpu",
                             mesh=_cpu_mesh(4))
