"""Port parity of the Pick stage: `gappadder_tpu_torch`'s
`align_flanks_to_contigs(device="cpu")` against the JAX function with
`use_pallas=False`, FlankHit by FlankHit and field by field; and
`pick_full`, `pick_extension` and `_pick_gaps` against the JAX ones on
the same hits and contig stores."""

import dataclasses

import numpy as np
import pytest

from gappadder_tpu.config import Config as JConfig
from gappadder_tpu.pipeline import pick as jpick
from gappadder_tpu.pipeline import run as jrun
from gappadder_tpu_torch import dna
from gappadder_tpu_torch.config import Config
from gappadder_tpu_torch.parallel import slice as sl
from gappadder_tpu_torch.pipeline import fused, pick, run
from gappadder_tpu_torch.testcases import sw_test_pairs

from test_torch_run_scenarios import one_torch_thread  # noqa: F401

KSET = ((17, 15), (21, 19))


def _rows(hits):
    return [[dataclasses.astuple(h) for h in g] for g in hits]


def _assembled(seed=0):
    """The skewed scenario's contigs (port, CPU), its flanks and its
    planted fills."""
    dims, args = sl.example_data(1, gaps_per_shard=3, gap_len=(64, 160),
                                 seed=seed, kset=KSET)
    rowtab = sl.run_step(dims, args, device="cpu")[4].numpy()
    readsets, per_gap, gaps = sl.example_reads(args, rowtab)
    R, md = run._bucket_of(max(len(p) for p in per_gap))
    gc = fused.assemble_batch(Config(draft_genome="d.fa", kmers=KSET),
                              list(range(dims.n_gaps)), per_gap, readsets,
                              R, args[22].shape[1], md, device="cpu")
    return gc, gaps, sl.example_fills(args, per_gap)


@pytest.mark.parametrize("max_hits,min_score", [(3, 30), (1, 15)])
def test_align_flanks_matches_jax(max_hits, min_score):
    gc, gaps, _ = _assembled()
    a = (gaps["flank_left"], gaps["flank_right"], gc.seq, gc.length,
         gc.count)
    want = jpick.align_flanks_to_contigs(*a, min_score=min_score,
                                         use_pallas=False, max_hits=max_hits)
    got = pick.align_flanks_to_contigs(*a, min_score=min_score,
                                       max_hits=max_hits, device="cpu")
    assert _rows(got) == _rows(want)
    assert all(len(g) > 0 for g in got)


def test_multi_hit_secondary_matches_jax(rng):
    """tests/test_pick_oracle.py's adversarial case: the left flank's
    best local hit is a both-clipped decoy, the true placement a weaker
    secondary hit that only the mask-and-rerun passes surface."""
    b = np.array(list("ACGT"))
    FL = "".join(b[rng.integers(0, 4, 300)])
    FR = "".join(b[rng.integers(0, 4, 300)])
    fill = "".join(b[rng.integers(0, 4, 150)])
    contig = FL[100:] + fill + FR + "TT" + FL[5:295] + "GG"
    codes = dna.encode(contig)
    cseq = codes[None, None]
    clen = np.array([[len(codes)]], np.int32)
    ccnt = np.array([1], np.int32)
    fl, fr = dna.encode(FL)[None], dna.encode(FR)[None]
    for max_hits in (1, 3):
        want = jpick.align_flanks_to_contigs(fl, fr, cseq, clen, ccnt,
                                             min_score=30, max_hits=max_hits)
        got = pick.align_flanks_to_contigs(fl, fr, cseq, clen, ccnt,
                                           min_score=30, max_hits=max_hits,
                                           device="cpu")
        assert _rows(got) == _rows(want)
    res = pick.pick_full(got[0], cseq[0], clen[0])
    assert dna.decode(res[1]) == fill
    np.testing.assert_array_equal(res[1], jpick.pick_full(
        want[0], cseq[0], clen[0])[1])


def _rand_hits(rng, n_contigs, clen):
    rows = []
    for c in range(n_contigs):
        for side in ("left", "right"):
            for _ in range(int(rng.integers(0, 4))):
                ct = int(rng.choice([pick.UNCLIP, pick.LEFT_CLIP,
                                     pick.RIGHT_CLIP, pick.BOTH_CLIP]))
                ml = int(rng.integers(20, 140))
                ts = int(rng.integers(0, max(clen - ml, 1)))
                rows.append((c, side, bool(rng.integers(0, 2)), ml, ts + 1,
                             ml, ct, 0, ml, ts + ml))
    return rows


def _same(a, b):
    if a is None or b is None:
        return a is None and b is None
    return all(np.array_equal(np.asarray(x), np.asarray(y))
               for x, y in zip(a, b)) and len(a) == len(b)


@pytest.mark.parametrize("seed", range(6))
def test_pick_full_and_extension_match_jax(seed):
    rng = np.random.default_rng(seed)
    n_contigs, clen = int(rng.integers(1, 5)), 400
    contigs = rng.integers(0, 4, (n_contigs, clen)).astype(np.int8)
    lens = rng.integers(200, clen + 1, n_contigs).astype(np.int32)
    rows = _rand_hits(rng, n_contigs, clen)
    th = [pick.FlankHit(*r) for r in rows]
    jh = [jpick.FlankHit(*r) for r in rows]
    assert _same(pick.pick_full(th, contigs, lens),
                 jpick.pick_full(jh, contigs, lens))
    assert _same(pick.pick_extension(th, contigs, lens),
                 jpick.pick_extension(jh, contigs, lens))


def test_pick_gaps_matches_jax():
    gc, gaps, truth = _assembled(seed=1)
    store = {}
    for g in range(len(gc.count)):
        n = int(gc.count[g])
        clist = [gc.seq[g, j, :gc.length[g, j]] for j in range(n)]
        store[g] = run._tuple_from_list(clist, gc.names[g])
    # gap 2 starts with a fill, so both skip it; one gap has no contigs
    store[3] = run._tuple_from_list([], [])
    out = {}
    for mod, cfg, kw in ((jrun, JConfig(draft_genome="d.fa"), {}),
                         (run, Config(draft_genome="d.fa"),
                          {"device": "cpu"})):
        fills, exts = {2: (np.zeros(1, np.int8), "x")}, {}
        mod._pick_gaps(cfg, gaps, [0, 1, 2, 3], store, fills, exts, 30,
                       True, **kw)
        out[mod.__name__] = (fills, exts)
    (jf, je), (tf, te) = out[jrun.__name__], out[run.__name__]
    assert jf.keys() == tf.keys() == {0, 1, 2}
    for g in jf:
        np.testing.assert_array_equal(jf[g][0], tf[g][0])
        assert jf[g][1] == tf[g][1]
    assert je.keys() == te.keys()
    # the fills are the planted bases between the flanks
    for g in (0, 1):
        np.testing.assert_array_equal(tf[g][0], truth[g])


@pytest.mark.parametrize("mode", ["local", "fit"])
def test_host_traceback_matches_jax(mode):
    """Pick's host traceback: `alignment_stats_batch` (one batched DP
    fill, chunked by `max_bytes`), `alignment_stats` and `traceback`
    against the JAX package's, from the endpoints the SW pass gives."""
    from gappadder_tpu.ops import sw_host as jsw_host
    from gappadder_tpu_torch.ops import sw_host, swutil
    q, ql, t, tl = sw_test_pairs(11, B=16, Lq=30, Lt=60)
    ql, tl = np.maximum(ql, 1), np.maximum(tl, 1)
    s, qe, te = swutil.sw_pairs(q, ql, t, tl, sw_host.BWA_PARAMS, mode,
                                device="cpu")
    # every fit pair has an alignment; a local one needs a positive score
    win = np.nonzero(s > 0)[0] if mode == "local" else np.arange(len(s))
    assert len(win) >= 8
    args = (q[win], ql[win], t[win], tl[win])
    got = sw_host.alignment_stats_batch(*args, sw_host.BWA_PARAMS, mode,
                                        qe[win], te[win], max_bytes=1 << 16)
    want = jsw_host.alignment_stats_batch(*args, jsw_host.BWA_PARAMS, mode,
                                          qe[win], te[win])
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)
    for i in win:
        qi, ti = q[i, :ql[i]], t[i, :tl[i]]
        a = (int(qe[i]), int(te[i]))
        assert sw_host.alignment_stats(qi, ti, sw_host.BWA_PARAMS, mode, *a) \
            == jsw_host.alignment_stats(qi, ti, jsw_host.BWA_PARAMS, mode, *a)
        assert sw_host.traceback(qi, ti, sw_host.BWA_PARAMS, mode, *a) \
            == jsw_host.traceback(qi, ti, jsw_host.BWA_PARAMS, mode, *a)
