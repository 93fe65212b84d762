"""The device operations of the port's Collect on the CPU against the
JAX package's: the low-mapq second pass (`classify_lowmapq`), the
recruitment union (`recruit_on_device`), the window overlap count
(`max_overlap_np`) and the mate columns of the fused step's
classification block (`_classify_extract(with_mates=True)`), on seeded
inputs. Exact equality."""

import dataclasses

import numpy as np
import pytest
import jax.numpy as jnp
import torch

from gappadder_tpu.ops import classify as jclassify
from gappadder_tpu.ops import intervals as jintervals
from gappadder_tpu.ops import recruit as jrecruit
from gappadder_tpu.parallel import slice as jsl
from gappadder_tpu.pipeline.collect import _pad_windows
from gappadder_tpu_torch.ops import classify as tclassify
from gappadder_tpu_torch.ops import intervals as tintervals
from gappadder_tpu_torch.ops import recruit as trecruit
from gappadder_tpu_torch.parallel import slice as tsl


def _mate_windows(rng, n_mates, n_tid=3, span=4000):
    """Pass 2's windows as the JAX Collect builds them: distinct
    (tid, mp, gap) rows, [mp - 199, mp + 299], sorted and padded."""
    mt = rng.integers(0, n_tid, n_mates)
    # a few mate positions shared by several gaps (linked gaps)
    mp = rng.integers(300, span, n_mates)
    mp[1::4] = mp[0::4][:len(mp[1::4])]
    mt[1::4] = mt[0::4][:len(mt[1::4])]
    mg = rng.integers(0, 6, n_mates)
    mt, mp, mg = np.unique(np.stack([mt, mp, mg]), axis=1)
    _, cnts = np.unique(np.stack([mt, mp]), axis=1, return_counts=True)
    fan2 = min(int(cnts.max()) + 1, max(1, len(mt)))
    res = jintervals.sort_windows(*(jnp.asarray(x.astype(np.int32)) for x in
                                    (mt, mp - 199, mp + 299, mg, mp)))
    wp = _pad_windows({k: np.asarray(v) for k, v in
                       zip(("tid", "start", "end", "gap", "mp"), res)})
    return [wp[k] for k in ("tid", "start", "end", "gap", "mp")], fan2, \
        (mt, mp)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_classify_lowmapq_matches_jax(seed):
    rng = np.random.default_rng(seed)
    win, fan2, (mt, mp) = _mate_windows(rng, 60)
    n = 700
    tid = rng.integers(-1, 3, n).astype(np.int32)
    pos = rng.integers(0, 4400, n).astype(np.int32)
    # half the reads right at a mate position's window edges
    k = rng.integers(0, len(mp), n // 2)
    tid[:n // 2] = mt[k]
    pos[:n // 2] = mp[k] + rng.choice([-200, -199, 0, 299, 300], n // 2)
    flag = rng.choice([0x41, 0x81, 0x45, 0x89], n).astype(np.int32)
    mapq = rng.choice([0, 0, 0, 20, 60], n).astype(np.int32)
    want = jclassify.classify_lowmapq(*(jnp.asarray(x) for x in
                                        (tid, pos, flag, mapq, *win)),
                                      fanout=fan2)
    got = tclassify.classify_lowmapq(*(torch.from_numpy(x) for x in
                                       (tid, pos, flag, mapq, *win)),
                                     fanout=fan2)
    for w, g in zip(want, got):
        w = np.asarray(w)
        assert g.dtype == torch.int32 and w.shape == tuple(g.shape)
        np.testing.assert_array_equal(w, g.numpy())
    gap = got[0].numpy()
    assert (gap >= 0).any() and (gap.max(axis=1) == -1).any()
    # several linked gaps tie on the largest mate position somewhere
    assert ((gap >= 0).sum(axis=1) > 1).any()


class _Names:
    """What the union reads of a read set: its size and name hashes."""

    def __init__(self, name_hash):
        self.name_hash = np.asarray(name_hash, np.uint64)

    @property
    def n(self):
        return len(self.name_hash)


@pytest.mark.parametrize("seed", [0, 1])
def test_recruit_on_device_matches_jax(seed):
    rng = np.random.default_rng(seed)
    pool = rng.integers(0, 1 << 63, 400, dtype=np.int64).astype(np.uint64)
    pool[:4] = [0, 1, 0xFFFFFFFF, 0xFFFFFFFF00000000]    # word edges
    left = _Names(pool[rng.permutation(300)])
    right = _Names(np.concatenate([pool[rng.permutation(300)][:250],
                                   pool[:10]]))         # repeated names
    R = 900
    gap = rng.integers(-1, 7, R)
    side = rng.integers(0, 2, R)
    h = pool[rng.integers(0, 400, R)]                   # some in no table
    hq = rng.random(R) < 0.3
    gap[R // 2:R // 2 + 100] = gap[:100]                # duplicate entries
    side[R // 2:R // 2 + 100] = side[:100]
    h[R // 2:R // 2 + 100] = h[:100]
    want = jrecruit.recruit_on_device(gap, side, h, hq, (left, right))
    got = trecruit.recruit_on_device(gap, side, h, hq, (left, right),
                                     device="cpu")
    assert sorted(want) == sorted(got)
    for k in want:
        assert want[k].dtype == got[k].dtype, k
        np.testing.assert_array_equal(want[k], got[k], err_msg=k)
    assert got["hq"].any() and len(got["gap"]) > 100
    empty = trecruit.recruit_on_device(gap[:0], side[:0], h[:0], hq[:0],
                                       (left, right), device="cpu")
    assert all(len(v) == 0 for v in empty.values())


def test_recruit_on_device_refuses_without_gpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    args = (np.zeros(1, np.int64), np.zeros(1, np.int64),
            np.zeros(1, np.uint64), np.zeros(1, bool),
            (_Names([0]), _Names([0])))
    for kw in ({}, {"device": "cuda"}):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            trecruit.recruit_on_device(*args, **kw)
    assert len(trecruit.recruit_on_device(*args, device="cpu")["gap"]) == 1


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_max_overlap_np_matches_jax(seed):
    rng = np.random.default_rng(seed)
    n = int(rng.integers(0, 60))
    tid = rng.integers(0, 3, n)
    start = rng.integers(0, 2000, n)
    end = start + rng.integers(0, 600, n)
    assert tintervals.max_overlap_np(tid, start, end) == \
        jintervals.max_overlap_np(tid, start, end)


def _with_disc(args):
    """example_data's records, some made discordant: mates on another
    scaffold or a long template, so the disc third holds live mates."""
    args = [np.array(a) for a in args]
    args[4][::5] = 1            # mtid: another scaffold
    args[6][1::3] = 1000        # tlen past dist2
    args[5][::2] += 17          # mpos: not the read's own position
    return tuple(args)


@pytest.mark.parametrize("disc", [False, True])
def test_classify_extract_mate_columns_match_jax(disc):
    jd, args = jsl.example_data(1, gaps_per_shard=3, use_pallas=False)
    if disc:
        args = _with_disc(args)
    td = tsl.dims_from_fields(dataclasses.asdict(jd))
    (jent, (jmt, jmp), jc3) = jsl._classify_extract(
        *(jnp.asarray(a) for a in args[:18]), dims=jd)
    targs = tsl.inputs_from_numpy(args[:18], "cpu")
    tent, (tmt, tmp), tc3 = tsl._classify_extract(*targs, dims=td,
                                                  with_mates=True)
    plain_ent, plain_c3 = tsl._classify_extract(*targs, dims=td)
    for w, g, p in zip(jent, tent, plain_ent):
        np.testing.assert_array_equal(np.asarray(w), g.numpy())
        assert torch.equal(g, p)
    np.testing.assert_array_equal(np.asarray(jmt), tmt.numpy())
    np.testing.assert_array_equal(np.asarray(jmp), tmp.numpy())
    np.testing.assert_array_equal(np.asarray(jc3), tc3.numpy())
    assert torch.equal(tc3, plain_c3)
    live = tent[5].numpy()
    third = len(live) // 3
    disc_live = live[third:2 * third]
    assert disc_live.any() == disc
    if disc:
        assert (tmt.numpy()[third:2 * third][disc_live] >= 0).all()
    # the clip and unmap thirds carry no mate
    assert (tmt.numpy()[:third] == -1).all()
    assert (tmp.numpy()[2 * third:] == -1).all()
