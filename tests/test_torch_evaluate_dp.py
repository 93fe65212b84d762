"""The port's Evaluate DP (`ops/evaluate_dp.eval_pairs_device`) on the
CPU: the ragged pack, its longest-first order and the scatter back to
the callers' order, which the card path shares, against the JAX
package's `eval_pairs_device` on the same pairs, and the refine that
calls it against the JAX package's. Exact: every output is integers."""

import dataclasses

import numpy as np
import pytest
import torch

from gappadder_tpu.ops import evaluate_dp as jeval
from gappadder_tpu.ops import merge_engine as jme
from gappadder_tpu.pipeline import run as jrun
from gappadder_tpu_torch.ops import cuda_build, evaluate_dp, merge_engine
from gappadder_tpu_torch.pipeline import run
from gappadder_tpu_torch.testcases import (EVAL_STRIP_ROWS,
                                           evaluate_test_pairs,
                                           refine_test_items)
from gappadder_tpu_torch.utils import meters


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """One intra-op thread: the plain DP runs thousands of small tensor
    steps, which a pool of threads does not speed up, and the pool's
    waiting threads slow the other test workers on the same cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.mark.parametrize("max_clip", [0, 2, 50])
def test_ragged_path_matches_jax(max_clip):
    """Shuffled ragged pairs: lengths 0 and 1, pairs shorter than the
    clip (lines of index below 0), all-N, poly-A, ACAC... and tiny
    two- and three-letter pairs for the tie rules, overlaps and
    containments."""
    pairs = evaluate_test_pairs(300 + max_clip, count=30, lmax=200)
    np.testing.assert_array_equal(
        evaluate_dp.eval_pairs_device(pairs, max_clip, device="cpu"),
        jeval.eval_pairs_device(pairs, max_clip))


def test_ragged_path_past_one_strip_matches_jax():
    """Queries of 1024, 1025 and 2049 rows beside short pairs, under the
    merge's scores and under others."""
    pairs = evaluate_test_pairs(5, count=4, lmax=120, long_rows=EVAL_STRIP_ROWS,
                                long_cols=70, tiny=20)
    for sc in ((1, -2, -2), (2, -1, -3)):
        np.testing.assert_array_equal(
            evaluate_dp.eval_pairs_device(pairs, 50, *sc, device="cpu"),
            jeval.eval_pairs_device(pairs, 50, *sc))


def test_pack_is_longest_first_and_results_come_back_in_order():
    pairs = evaluate_test_pairs(11, count=20, lmax=150, tiny=30)
    pack = evaluate_dp.pack_pairs(pairs)
    n, m = pack.meta[:, 1].astype(np.int64), pack.meta[:, 3].astype(np.int64)
    assert np.all(np.diff(n * m) <= 0)
    assert sorted(pack.order.tolist()) == list(range(len(pairs)))
    for k, i in enumerate(pack.order):
        a, b = pack.pair(k)
        s1, s2 = pairs[i]
        assert a.tolist() == (s1.tolist() or [evaluate_dp.Q_EMPTY])
        assert b.tolist() == (s2.tolist() or [evaluate_dp.T_EMPTY])
    assert pack.scratch_len == 0 and np.all(pack.meta[:, 4] == -1)
    got = evaluate_dp.eval_pairs_device(pairs, 50, device="cpu")
    for i in range(0, len(pairs), 7):
        np.testing.assert_array_equal(
            got[i], evaluate_dp.eval_pairs_device([pairs[i]], 50,
                                                  device="cpu")[0])


def test_pack_gives_strip_pairs_a_scratch_row():
    rng = np.random.default_rng(0)
    pairs = [(rng.integers(0, 4, n).astype(np.int8),
              rng.integers(0, 4, m).astype(np.int8))
             for n, m in ((1024, 30), (1025, 40), (20, 20), (2049, 50))]
    pack = evaluate_dp.pack_pairs(pairs)
    rows = {int(pack.meta[k, 1]): (int(pack.meta[k, 3]), int(pack.meta[k, 4]))
            for k in range(4)}
    assert rows[1024][1] == rows[20][1] == -1
    assert {rows[1025][1], rows[2049][1]} == {0, 50}
    assert pack.scratch_len == 90


def test_card_path_launches_the_kernel_or_raises(monkeypatch):
    """A CUDA device never falls back to the plain version: where the
    kernel cannot be built or loaded, the call raises."""
    def no_kernel(name):
        raise RuntimeError(f"nvcc not found ({name})")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(cuda_build, "load", no_kernel)
    before = evaluate_dp.launches
    with pytest.raises(RuntimeError, match="nvcc not found"):
        evaluate_dp.eval_pairs_device(evaluate_test_pairs(1, count=2, tiny=2),
                                      50, device="cuda")
    assert evaluate_dp.launches == before


def test_evaluate_span_counts_pairs_cells_and_launches():
    pairs = evaluate_test_pairs(2, count=6, lmax=80, tiny=5)
    with meters.Meters() as m:
        merge_engine.evaluate_pairs(pairs, merge_engine.MergeConfig(),
                                    device="cpu")
        merge_engine.evaluate_pairs([], merge_engine.MergeConfig(),
                                    device="cpu")
    rec = m.stages["assembly.evaluate"]
    assert rec["pairs"] == len(pairs)
    assert rec["cells"] == sum(max(len(a), 1) * max(len(b), 1)
                               for a, b in pairs)
    assert rec["launches"] == 0          # the CPU launches no kernel


def test_refine_on_the_test_gaps_matches_jax():
    """`refine_contigs_multi` (dedup, the overlap merge and its Evaluate
    calls, splicing) on testcases' gaps of overlapping windows, against
    the JAX package's."""
    items = refine_test_items(3, n_gaps=3, lmin=300, lmax=600, win=(100, 250))
    cfg = merge_engine.MergeConfig()
    got = run.refine_contigs_multi(items, cfg, device="cpu")
    want = jrun.refine_contigs_multi(
        items, jme.MergeConfig(**dataclasses.asdict(cfg)))
    assert len(got) == len(want)
    for (gc, gn, gi), (wc, wn, wi) in zip(got, want):
        assert [c.tolist() for c in gc] == [c.tolist() for c in wc]
        assert gn == wn and gi == wi
