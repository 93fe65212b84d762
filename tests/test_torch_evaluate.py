"""Port parity of tools/evaluate.py: the six functions of the JAX
package's module (gappadder_tpu/tools/evaluate.py) and the port's, on
the same seeded inputs, with exact equality. The port runs on the CPU,
where its SW calls take the kernel's plain version."""

import numpy as np
import pytest

from gappadder_tpu import dna as jdna
from gappadder_tpu.io import fasta as jfasta
from gappadder_tpu.tools import evaluate as jev
from gappadder_tpu_torch.io import fasta as tfasta
from gappadder_tpu_torch.tools import evaluate as tev

from test_torch_run_scenarios import one_torch_thread  # noqa: F401


def genomes(scaffolds, names=None):
    """The same scaffolds as a JAX and a port Genome."""
    names = names or [f"s{i}" for i in range(len(scaffolds))]
    lens = np.array([len(s) for s in scaffolds], np.int64)
    offs = np.concatenate([[0], np.cumsum(lens + 1)[:-1]]).astype(np.int64)
    seq = np.full(int(lens.sum()) + len(scaffolds) - 1, jdna.SEP, np.int8)
    for o, s in zip(offs, scaffolds):
        seq[o:o + len(s)] = s
    return (jfasta.Genome(seq=seq, offsets=offs, lengths=lens, names=names),
            tfasta.Genome(seq=seq.copy(), offsets=offs.copy(),
                          lengths=lens.copy(), names=list(names)))


def test_best_placement_fallback_matches_jax():
    """The literal full-DP placement on a few-kb genome: both strands,
    a query with a mismatch, one spanning no scaffold well, an empty
    scaffold skipped."""
    rng = np.random.default_rng(1)
    s0 = rng.integers(0, 4, 1500).astype(np.int8)
    s1 = rng.integers(0, 4, 900).astype(np.int8)
    jg, tg = genomes([s0, np.zeros(0, np.int8), s1])
    mism = s1[300:420].copy()
    mism[60] = (mism[60] + 1) % 4
    queries = [s0[700:800], jdna.revcomp(s1[100:180]), mism,
               rng.integers(0, 4, 50).astype(np.int8)]
    for q in queries:
        want = jev._best_placement(q, jg)
        got = tev._best_placement(q, tg, device="cpu")
        assert got == want
    assert tev._best_placement(queries[1], tg, device="cpu")[:2] == (2, 1)


def test_seeded_placements_matches_jax():
    """A 200 kb genome, 20 queries of each kind tests/test_tools.py's
    large-genome case draws (forward, reverse, a 2-bp deletion, a 3-bp
    insertion); every query seeds, so no full-DP fallback runs."""
    rng = np.random.default_rng(2)
    L = 200_000
    seq = rng.integers(0, 4, L).astype(np.int8)
    jg, tg = genomes([seq])
    queries = []
    for i in range(80):
        st = int(rng.integers(0, L - 400))
        q = seq[st:st + 295].copy()
        kind = i % 4
        if kind == 1:
            q = jdna.revcomp(q)
        elif kind == 2:
            q = np.concatenate([q[:150], q[152:]])
        elif kind == 3:
            q = np.concatenate([q[:150], rng.integers(0, 4, 3).astype(
                np.int8), q[150:]])
        queries.append(q)
    want = jev.seeded_placements(queries, jg)
    got = tev.seeded_placements(queries, tg, device="cpu")
    assert all(p is not None for p in want)
    assert got == want
    assert {p[1] for p in got} == {0, 1}


def _gap_case(rng):
    """Three gaps on a two-scaffold draft whose finished genome holds
    the first scaffold forward and the second reverse-complemented; the
    third gap's left flank is too short to place."""
    t0 = rng.integers(0, 4, 1500).astype(np.int8)
    t1 = rng.integers(0, 4, 1200).astype(np.int8)
    spans = [(0, 400, 520), (1, 600, 700), (1, 20, 50)]
    FL = 100
    fl = np.full((3, FL), jdna.N, np.int8)
    fr = np.full((3, FL), jdna.N, np.int8)
    ll, rl = np.zeros(3, np.int32), np.zeros(3, np.int32)
    for g, (si, gs, ge) in enumerate(spans):
        t = (t0, t1)[si]
        a = t[max(gs - FL, 0):gs - 5]
        b = t[ge + 5:ge + FL]
        fl[g, :len(a)], fr[g, :len(b)] = a, b
        ll[g], rl[g] = len(a), len(b)
    gaps = {"start": np.array([s[1] for s in spans]),
            "end": np.array([s[2] for s in spans]),
            "scaffold": np.array([s[0] for s in spans]),
            "number": np.array([1, 1, 2]),
            "local_start": np.array([s[1] for s in spans]),
            "local_end": np.array([s[2] for s in spans])}
    finished = [t0, jdna.revcomp(t1)]
    truth = {0: t0[395:525], 1: t1[595:705]}
    return gaps, finished, fl, fr, (ll, rl), truth


def test_extract_true_gap_seqs_matches_jax():
    gaps, finished, fl, fr, lens, truth = _gap_case(np.random.default_rng(3))
    jg, tg = genomes(finished)
    want = jev.extract_true_gap_seqs(gaps, jg, fl, fr, lens)
    got = tev.extract_true_gap_seqs(gaps, tg, fl, fr, lens, device="cpu")
    assert sorted(got) == sorted(want) == [0, 1]
    for g in want:
        np.testing.assert_array_equal(got[g], want[g])
        np.testing.assert_array_equal(got[g], truth[g])


def test_closure_stats_matches_jax():
    """Exact, reverse-strand, clipped, wrong, empty and truthless fills."""
    rng = np.random.default_rng(4)
    truths = {g: rng.integers(0, 4, 150).astype(np.int8) for g in range(5)}
    junk = rng.integers(0, 4, 40).astype(np.int8)
    picked = {0: truths[0].copy(),
              1: jdna.revcomp(truths[1]),
              2: np.concatenate([junk, truths[2]]),
              3: rng.integers(0, 4, 150).astype(np.int8),
              4: np.zeros(0, np.int8),
              7: truths[0][:90].copy()}
    want = jev.closure_stats(picked, truths)
    got = tev.closure_stats(picked, truths, device="cpu")
    assert got == want
    assert got["hit_list"] == [0, 1]


def test_extract_filled_regions_matches_jax():
    rng = np.random.default_rng(5)
    gaps = {"scaffold": np.array([0, 0, 1]),
            "local_start": np.array([100, 400, 50]),
            "local_end": np.array([150, 420, 90])}
    fills = {0: rng.integers(0, 4, 70).astype(np.int8),
             1: rng.integers(0, 4, 12).astype(np.int8),
             2: rng.integers(0, 4, 55).astype(np.int8)}
    jg, tg = genomes([rng.integers(0, 4, 700).astype(np.int8),
                      rng.integers(0, 4, 300).astype(np.int8)])
    want = jev.extract_filled_regions(jg, gaps, fills)
    got = tev.extract_filled_regions(tg, gaps, fills)
    assert sorted(got) == sorted(want)
    for g in want:
        np.testing.assert_array_equal(got[g], want[g])


class _Reads:
    """A read store with the two members the statistic reads."""

    def __init__(self, seqs):
        self.length = np.array([len(s) for s in seqs], np.int32)
        self.seq = np.full((len(seqs), max(self.length)), jdna.N, np.int8)
        for i, s in enumerate(seqs):
            self.seq[i, :len(s)] = s

    def get_seq(self, row):
        return self.seq[row, :self.length[row]]


def test_discordant_alignment_stats_matches_jax():
    rng = np.random.default_rng(6)
    truths = {0: rng.integers(0, 4, 300).astype(np.int8),
              1: rng.integers(0, 4, 200).astype(np.int8),
              2: rng.integers(0, 4, 5).astype(np.int8)}
    seqs = []
    for i in range(30):
        t = truths[i % 2]
        st = int(rng.integers(0, len(t) - 60))
        r = t[st:st + int(rng.integers(40, 60))]
        kind = i % 3
        if kind == 1:
            r = jdna.revcomp(r)
        elif kind == 2:
            r = rng.integers(0, 4, len(r)).astype(np.int8)
        seqs.append(r)
    readsets = [(_Reads(seqs[:15]), _Reads(seqs[15:]))]
    rows = np.arange(30)
    rec = {"gap": np.where(rows % 2 == 0, 0, 1) + (rows == 29) * 1,
           "lib": np.zeros(30, np.int32),
           "side": (rows >= 15).astype(np.int32),
           "row": rows % 15}
    want = jev.discordant_alignment_stats(rec, readsets, truths, None)
    got = tev.discordant_alignment_stats(rec, readsets, truths, None,
                                         device="cpu")
    assert got == want
    assert sorted(got) == [0, 1]
