"""Port parity of the whole fused step: `gappadder_tpu_torch`'s
`run_step(device="cpu")` against the JAX `_step` on a one-device mesh,
all 12 outputs exactly equal, at the toy, skewed and six-setting
(k, sub_k) dims; the inputs themselves; and the capacity checks."""

import dataclasses

import numpy as np
import pytest
import jax

from gappadder_tpu.parallel import slice as jsl
from gappadder_tpu.parallel.mesh import make_mesh
from gappadder_tpu_torch.parallel import slice as tsl

NAMES = ("counts", "hist", "n_recv", "n_reads", "rowtab", "hqtab", "useq",
         "ulen", "ucnt", "score", "qend", "tend")
KSET6 = ((30, 29), (30, 27), (40, 39), (40, 37), (50, 49), (50, 47))
SCENARIOS = {
    "toy": dict(gaps_per_shard=2),
    "skewed": dict(gaps_per_shard=3, gap_len=(64, 160)),
    "six_settings": dict(gaps_per_shard=1, read_len=100, step=8,
                         flank_len=300, gap_len=160, kset=KSET6),
}


def _jax_step(dims, args):
    mesh = make_mesh(shape=(1,), axes=("dp",), devices=jax.devices()[:1])
    out = jsl.make_slice_step(mesh, dims)(*jsl.place_args(mesh, args))
    return [np.asarray(o) for o in out]


@pytest.mark.parametrize("name", list(SCENARIOS))
def test_example_data_matches_jax(name):
    jd, ja = jsl.example_data(1, use_pallas=False, **SCENARIOS[name])
    td, ta = tsl.example_data(1, **SCENARIOS[name])
    assert len(ja) == len(ta) == 28
    for x, y in zip(ja, ta):
        assert x.dtype == y.dtype and x.shape == y.shape
        np.testing.assert_array_equal(x, y)
    assert tsl.dims_from_fields(dataclasses.asdict(jd)) == td


@pytest.mark.parametrize("name", list(SCENARIOS))
def test_step_outputs_match_jax(name):
    jd, args = jsl.example_data(1, use_pallas=False, **SCENARIOS[name])
    td = tsl.dims_from_fields(dataclasses.asdict(jd))
    want = _jax_step(jd, args)
    got = [o.numpy() for o in tsl.run_step(td, args, device="cpu")]
    assert len(got) == 12
    for nm, w, g in zip(NAMES, want, got):
        assert w.dtype == g.dtype, nm
        assert w.shape == g.shape, nm
        np.testing.assert_array_equal(w, g, err_msg=nm)
    tsl.check_overflow(td, got[0])


@pytest.mark.parametrize("field,tiny", [("entry_cap", 8),
                                        ("reads_per_gap", 4),
                                        ("max_distinct", 32),
                                        ("node_cap", 64)])
def test_undersized_caps_fire_check_overflow(field, tiny):
    dims, args = tsl.example_data(1, gaps_per_shard=2)
    small = dataclasses.replace(dims, **{field: tiny})
    counts = tsl.run_step(small, args, device="cpu")[0].numpy()
    with pytest.raises(OverflowError):
        tsl.check_overflow(small, counts)
    # the JAX step reports the same indicators
    jd, ja = jsl.example_data(1, gaps_per_shard=2, use_pallas=False)
    jcounts = _jax_step(dataclasses.replace(jd, **{field: tiny}), ja)[0]
    np.testing.assert_array_equal(counts, jcounts)


def test_toy_step_closes_planted_gaps():
    dims, args = tsl.example_data(1, gaps_per_shard=2)
    out = [o.numpy() for o in tsl.run_step(dims, args, device="cpu")]
    counts, n_reads, ulen, sc = out[0], out[3], out[7], out[9]
    assert int(counts[0]) == dims.n_gaps * 25
    assert int(n_reads.sum()) == dims.n_gaps * 25
    assert (ulen.max(axis=1) >= 128).all()
    assert (sc[:, 0:2].max(axis=(1, 2)) == 40).all()
    assert (sc[:, 2:4].max(axis=(1, 2)) == 40).all()
