"""Port parity of the contig merge: the port's Evaluate DP
(`ops/evaluate_dp.eval_pairs_device`, torch operators), `merge_engine`
(dedup, the overlap graph, path enumeration, splicing) and
`pipeline/run.refine_contigs_multi`, on the CPU, against the JAX
package's on the same numpy inputs. Exact: every output is integers,
codes or strings."""

import dataclasses

import numpy as np
import pytest
import torch

from gappadder_tpu import dna as jdna
from gappadder_tpu.ops import evaluate_dp as jeval
from gappadder_tpu.ops import merge_engine as jme
from gappadder_tpu.pipeline import run as jrun
from gappadder_tpu_torch.ops import evaluate_dp, merge_engine
from gappadder_tpu_torch.pipeline import run


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """One intra-op thread: the plain DPs run thousands of small tensor
    steps, which a pool of threads does not speed up, and the pool's
    waiting threads slow the other test workers on the same cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


CFGS = [merge_engine.MergeConfig(),
        merge_engine.MergeConfig(max_clip_len=7, min_overlap_len=5)]


def _jcfg(cfg):
    return jme.MergeConfig(**dataclasses.asdict(cfg))


def _rand(rng, n):
    return rng.integers(0, 4, n).astype(np.int8)


def _eval_cases(rng, n_pairs=40, lmax=300):
    """tests/test_merge.py's Evaluate pairs: random lengths, every other
    pair a real suffix/prefix overlap, some with an error, plus N runs
    (N matches N in the Evaluate DP)."""
    pairs = []
    for i in range(n_pairs):
        n = int(rng.integers(5, lmax))
        m = int(rng.integers(5, lmax))
        s1, s2 = _rand(rng, n), _rand(rng, m)
        if i % 2 == 0:
            k = int(rng.integers(4, min(n, m)))
            s2[:k] = s1[-k:]
            if rng.random() < 0.3:
                s2[int(rng.integers(0, k))] ^= 1
        if i % 7 == 3:
            s1[-3:] = jdna.N
            s2[:3] = jdna.N
        pairs.append((s1, s2))
    return pairs


def _ev(r):
    return (r.code, r.score, r.pos_row, r.pos_col, r.nclip, r.bcontained,
            r.is_containment, r.merged.tolist())


@pytest.mark.parametrize("relax", [False, True])
def test_evaluate_pairs_match_jax(rng, relax):
    pairs = _eval_cases(rng)
    for cfg in CFGS:
        raw = evaluate_dp.eval_pairs_device(pairs, cfg.max_clip_len,
                                            device="cpu")
        np.testing.assert_array_equal(
            raw, jeval.eval_pairs_device(pairs, cfg.max_clip_len))
        got = merge_engine.evaluate_pairs(pairs, cfg, relax=relax,
                                          device="cpu")
        want = jme.evaluate_pairs(pairs, _jcfg(cfg), relax=relax)
        assert [_ev(g) for g in got] == [_ev(w) for w in want]
        # and the copied host oracle agrees with the device kernel
        for (s1, s2), g in zip(pairs[:8], got):
            assert _ev(merge_engine.evaluate_pair(s1, s2, cfg,
                                                  relax=relax)) == _ev(g)


def _chain(rng, n, seg=60, ov=25):
    truth = _rand(rng, n * seg + ov)
    out = [truth[i * seg:i * seg + seg + ov].copy() for i in range(n)]
    rng.shuffle(out)
    return out


def _branching(rng):
    """Truth windows with 40-60 bp overlaps, decoys that share a
    window's 45-bp suffix and then diverge, and noise contigs."""
    L = int(rng.integers(500, 800))
    truth = _rand(rng, L)
    bounds = [0]
    while bounds[-1] < L - 180:
        bounds.append(bounds[-1] + int(rng.integers(120, 180)))
    bounds.append(L)
    windows = [truth[max(0, bounds[i] - (int(rng.integers(40, 60))
                                         if i else 0)):bounds[i + 1]].copy()
               for i in range(len(bounds) - 1)]
    decoys = [np.concatenate([w[-45:], _rand(rng, 80)])
              for w in windows[:-1][:2]]
    contigs = windows + decoys + [_rand(rng, 100) for _ in range(2)]
    return [contigs[i] for i in rng.permutation(len(contigs))]


def _gap_sets(rng):
    X, Y = _rand(rng, 150), _rand(rng, 150)
    core = _rand(rng, 120)
    return {
        "chains": [_chain(rng, int(rng.integers(2, 5))) for _ in range(3)],
        "branching": [_branching(rng) for _ in range(2)],
        "two_cycle": [[np.concatenate([X, Y]), np.concatenate([Y, X])]],
        "palindrome": [[np.concatenate([core, jdna.revcomp(core[:40])]),
                        _rand(rng, 100)]],
        "mixed": [_chain(rng, 3) + [_rand(rng, 120)], []],
    }


@pytest.mark.parametrize("kind", ["chains", "branching", "two_cycle",
                                  "palindrome", "mixed"])
def test_merge_contigs_multi_matches_jax(rng, kind):
    """Merged sequences, node paths, the overlap graph and its GML dump
    equal the JAX package's, gap by gap, in one batched call."""
    gaps = _gap_sets(rng)[kind]
    cfg = merge_engine.MergeConfig()
    graphs, jgraphs = ([{} for _ in gaps] for _ in range(2))
    got = merge_engine.merge_contigs_multi(gaps, cfg, graph_outs=graphs,
                                           device="cpu")
    want = jme.merge_contigs_multi(gaps, _jcfg(cfg), graph_outs=jgraphs)
    for (gm, gi), (wm, wi) in zip(got, want):
        assert gi == wi
        assert [m.tolist() for m in gm] == [m.tolist() for m in wm]
    assert graphs == jgraphs
    for contigs, g in zip(gaps, graphs):
        names = [f"c{i}" for i in range(len(contigs))]
        assert merge_engine.merge_graph_gml(names, g) == \
            jme.merge_graph_gml(names, g)
    if kind in ("chains", "branching"):
        assert all(m for m, _ in got)


def test_dedup_contigs_multi_matches_jax(rng):
    """Exact and revcomp duplicates, containment, near-duplicates and
    distinct contigs over several gaps, one batched SW screen."""
    gaps = []
    for _ in range(4):
        a, big = _rand(rng, 200), _rand(rng, 400)
        near = big.copy()
        near[::97] = (near[::97] + 1) % 4
        gaps.append([a, a.copy(), jdna.revcomp(a), big[100:250].copy(), big,
                     near, _rand(rng, 150)])
    gaps.append([])
    for cfg in CFGS + [merge_engine.MergeConfig(dedup_cutoff=0.9)]:
        got = merge_engine.dedup_contigs_multi(gaps, cfg, device="cpu")
        assert got == jme.dedup_contigs_multi(gaps, _jcfg(cfg))
    assert got[0] != list(range(7))


@pytest.mark.parametrize("seed", range(4))
def test_enumerate_paths_matches_jax(seed):
    """Random small digraphs with twins and cycles."""
    rng = np.random.default_rng(seed)
    N = 2 * int(rng.integers(2, 7))
    edges = {}
    for _ in range(int(rng.integers(1, 3 * N))):
        a, b = int(rng.integers(0, N)), int(rng.integers(0, N))
        if a >> 1 != b >> 1:
            edges[(a, b)] = (int(rng.integers(10, 200)),)
    for cfg in (merge_engine.MergeConfig(),
                merge_engine.MergeConfig(max_paths_per_root=1)):
        assert merge_engine.enumerate_paths(N, edges, cfg) == \
            jme.enumerate_paths(N, edges, _jcfg(cfg))
        assert merge_engine._tarjan_scc(N, _adj(edges)) == \
            jme._tarjan_scc(N, _adj(edges))


def _adj(edges):
    adj = {}
    for a, b in edges:
        adj.setdefault(a, []).append(b)
    return adj


def test_refine_contigs_multi_merge_info_states_match_jax(rng):
    """The three merge-info states, gap by gap in one batch: lines when a
    merge produced contigs, [] when the merger ran and merged nothing,
    None when it did not run (no contigs, or the 1 MB size guard)."""
    assert run.MERGE_SKIP_BASES == jrun.MERGE_SKIP_BASES == 1 << 20
    chain = _chain(rng, 3)
    big = [np.full(run.MERGE_SKIP_BASES // 2 + 10, b, np.int8)
           for b in (0, 1)]
    items = [(chain, [f"c{i}" for i in range(3)]),
             ([_rand(rng, 100), _rand(rng, 120)], ["a", "b"]),
             ([], []),
             (big, ["x", "y"])]
    cfg = merge_engine.MergeConfig()
    got = run.refine_contigs_multi(items, cfg, device="cpu")
    want = jrun.refine_contigs_multi(items, _jcfg(cfg))
    for (gc, gn, gi), (wc, wn, wi) in zip(got, want):
        assert [c.tolist() for c in gc] == [c.tolist() for c in wc]
        assert gn == wn and gi == wi
    states = [i for _, _, i in got]
    assert states[0] and all(x.startswith("NEW_CONTIG_MERGE_")
                             for x in states[0])
    assert "NEW_CONTIG_MERGE_1" in got[0][1]
    assert states[1:] == [[], None, None]
