"""Port parity of the whole fused step: `gappadder_tpu_torch`'s
`run_step(device="cpu")` against the JAX `_step` on a one-device mesh,
all 12 outputs exactly equal, at the toy, skewed and six-setting
(k, sub_k) dims; the inputs themselves; the capacity checks; and block
3's batched DBG against one call a setting."""

import dataclasses

import numpy as np
import pytest
import jax
import torch

from gappadder_tpu.parallel import slice as jsl
from gappadder_tpu.parallel.mesh import make_mesh
from gappadder_tpu_torch.ops import dbg as tdbg
from gappadder_tpu_torch.ops.dbg import HIST_BUCKETS
from gappadder_tpu_torch.parallel import slice as tsl

from test_torch_run_scenarios import one_torch_thread  # noqa: F401

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


def _block3_one_call_a_setting(seq, rlen, dims):
    """Block 3 with one `assemble_unitigs` call a setting: the form the
    batched block must equal, output for output."""
    kc = {k: tsl._distinct_kmers(seq, rlen, k, dims) for k, _ in dims.kset}
    acc, _kstr, _nk, _cnt, distinct = kc[dims.kset[0][0]]
    h = (acc[..., 0] >> 16) % HIST_BUCKETS
    hist = torch.zeros(HIST_BUCKETS, dtype=torch.int32).index_add(
        0, torch.where(distinct, h, torch.zeros_like(h)).reshape(-1),
        distinct.reshape(-1).to(torch.int32))
    res = [tdbg.assemble_unitigs(
        kc[k][1], kc[k][2], kc[k][3], k=k, sub_k=sk,
        max_unitigs=dims.max_unitigs, max_len=dims.max_contig_len,
        min_len=dims.min_contig_len, pop_bubbles=dims.pop_bubbles,
        node_cap=dims.effective_node_cap(k),
        edge_cap=dims.effective_node_cap(k)) for k, sk in dims.kset]
    us, ul, uc, nn, ne = zip(*res)
    over = (max(int(x.max()) for x in nn), max(int(x.max()) for x in ne),
            max(int(kc[k][2].max()) for k in kc))
    return (torch.cat(us, dim=1), torch.cat(ul, dim=1),
            torch.stack(uc, dim=1), hist, over)


# (SliceDims changes, assemble_unitigs_multi calls, _core_lane calls):
# the scenario's uniform cap; auto caps with max_distinct 448, where
# k = 30 takes a node cap of 1,024 and k = 40 and 50 one of 2,048
BLOCK3_CAPS = {"uniform": ({}, 1, 2),
               "auto": (dict(node_cap=0, max_distinct=448), 2, 4)}


@pytest.mark.parametrize("name", list(BLOCK3_CAPS))
def test_block3_batches_settings_by_cap(name, monkeypatch):
    change, n_multi, n_core = BLOCK3_CAPS[name]
    dims, args = tsl.example_data(1, **dict(SCENARIOS["six_settings"],
                                            gaps_per_shard=2))
    rowtab = tsl.run_step(dims, args, device="cpu")[4]
    seq, rlen = tsl.gather_reads(rowtab, torch.from_numpy(args[22]),
                                 torch.from_numpy(args[23]))
    dims = dataclasses.replace(dims, **change)
    caps = {dims.effective_node_cap(k) for k, _ in dims.kset}
    assert len(caps) == n_multi
    want = _block3_one_call_a_setting(seq, rlen, dims)

    calls = {"multi": 0, "core": 0}

    def counted(key, fn):
        def inner(*a, **kw):
            calls[key] += 1
            return fn(*a, **kw)
        return inner

    monkeypatch.setattr(tdbg, "assemble_unitigs_multi",
                        counted("multi", tdbg.assemble_unitigs_multi))
    monkeypatch.setattr(tdbg, "_core_lane",
                        counted("core", tdbg._core_lane))
    got = tsl._assemble_block(seq, rlen, dims)
    assert calls == {"multi": n_multi, "core": n_core}
    for nm, w, g in zip(("useq", "ulen", "ucnt", "hist"), want, got):
        assert w.dtype == g.dtype and w.shape == g.shape, nm
        assert torch.equal(w, g), nm
    assert tuple(int(x) for x in got[4]) == want[4]
    assert int(got[2].sum()) > 0
