"""Port parity: the multi-setting DBG core (`assemble_unitigs_multi`),
JAX vs gappadder_tpu_torch, on the toy batches of
`testcases.DBG_MULTI_CASES` (two occurrence groups, a forced cycle, one
group mixing k so the keys pad to 3 limbs, no counts, popping 1 and 2
rounds with counts, caps the raw counts pass, an empty gap). All five
outputs of every setting must be exactly equal, to JAX and to one
`assemble_unitigs` call a setting; and the per-lane sub_k helpers equal
JAX's on random limbs with FULL rows, at every sub_k a limb count
holds."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gappadder_tpu.ops import dbg as jdbg
from gappadder_tpu_torch.ops import dbg as tdbg
from gappadder_tpu_torch.testcases import DBG_MULTI_CASES, dbg_multi_case

from test_torch_run_scenarios import one_torch_thread  # noqa: F401

FULL = 0xFFFFFFFF
# (lanes, key limbs) of each core batch: groups by occurrence rows,
# fewest rows first
GROUPS = {"two_groups": [(4, 2), (4, 2)], "mixed_limbs": [(6, 3)],
          "snp_pop1": [(4, 2), (2, 2)], "snp_pop2": [(4, 2), (2, 2)],
          "caps": [(4, 2), (4, 2)]}


def _port(name):
    settings, ks, nk, kc, kw = dbg_multi_case(name)
    t = lambda xs: None if xs is None else [torch.from_numpy(x) for x in xs]
    return settings, ks, nk, kc, kw, tdbg.assemble_unitigs_multi(
        t(ks), t(nk), t(kc), settings=settings, **kw)


def _equal(want, got):
    assert len(want) == len(got) == 5
    for x, y in zip(want, got):
        x = np.asarray(x)
        y = y.numpy() if torch.is_tensor(y) else np.asarray(y)
        assert x.dtype == y.dtype and x.shape == y.shape
        np.testing.assert_array_equal(x, y)


@pytest.mark.parametrize("name", list(DBG_MULTI_CASES))
def test_multi_matches_jax(name):
    settings, ks, nk, kc, kw, got = _port(name)
    j = lambda xs: None if xs is None else tuple(jnp.asarray(x) for x in xs)
    want = jdbg.assemble_unitigs_multi(j(ks), j(nk), j(kc),
                                       settings=settings, **kw)
    assert len(want) == len(got) == len(settings)
    for w, g in zip(want, got):
        _equal(w, g)
    if name == "caps":
        over = max(int(g[3].max()) for g in got), max(int(g[4].max())
                                                      for g in got)
        assert min(over) > kw["node_cap"]


@pytest.mark.parametrize("name", list(DBG_MULTI_CASES))
def test_multi_matches_one_call_a_setting(name, monkeypatch):
    batches = []
    core = tdbg._core_lane

    def record(occ, sub_k, cov, **kw):
        batches.append((occ.shape[0], occ.shape[-1]))
        return core(occ, sub_k, cov, **kw)

    monkeypatch.setattr(tdbg, "_core_lane", record)
    settings, ks, nk, kc, kw, got = _port(name)
    assert batches == GROUPS[name]
    batches.clear()
    for s, (k, sk) in enumerate(settings):
        one = tdbg.assemble_unitigs(
            torch.from_numpy(ks[s]), torch.from_numpy(nk[s]),
            None if kc is None else torch.from_numpy(kc[s]), k=k, sub_k=sk,
            **kw)
        _equal(got[s], one)
    assert len(batches) == len(settings)


def _limbs(nl, lanes, seed):
    """Random packed limbs [lanes, 9, nl] with FULL rows."""
    rng = np.random.default_rng(seed)
    limbs = rng.integers(0, 1 << 32, (lanes, 9, nl), dtype=np.uint64)
    limbs[:, ::4] = FULL
    return limbs


@pytest.mark.parametrize("nl", [1, 2, 3, 4])
@pytest.mark.parametrize("helper", ["_prefix_kmer_dyn", "_suffix_kmer_dyn"])
def test_prefix_suffix_dyn_match_jax(helper, nl):
    sub_k = np.arange(1, 16 * nl, dtype=np.int32)
    limbs = _limbs(nl, len(sub_k), nl)
    want = jax.vmap(getattr(jdbg, helper))(
        jnp.asarray(limbs.astype(np.uint32)), jnp.asarray(sub_k))
    got = getattr(tdbg, helper)(torch.from_numpy(limbs.astype(np.int64)),
                                torch.from_numpy(sub_k.astype(np.int64)))
    np.testing.assert_array_equal(np.asarray(want).astype(np.int64),
                                  got.numpy())


@pytest.mark.parametrize("nl", [1, 2, 3, 4])
def test_kmer_base_dyn_matches_jax(nl):
    pos = np.arange(16 * nl, dtype=np.int32)
    limbs = _limbs(nl, len(pos), 10 + nl)
    want = jax.vmap(jdbg._kmer_base_dyn)(
        jnp.asarray(limbs.astype(np.uint32)), jnp.asarray(pos))
    got = tdbg._kmer_base_dyn(torch.from_numpy(limbs.astype(np.int64)),
                              torch.from_numpy(pos.astype(np.int64)))
    np.testing.assert_array_equal(np.asarray(want), got.numpy())
