"""The plain DBG (`reference/dbg.py`) against the program's DBG core on
graphs planted to hold what the step's traffic makes: a tip one base
under the length rule's bound, long enough to emit, and a dead end one
base longer, which is no tip; a short dead end after a join, which is
no tip either; a branch, more
eligible chains than slots with ties in length, a cycle, and chains cut
at the contig length. Both must emit the same unitigs in the same slot
order (this test imports the program; the reference does not)."""

import numpy as np
import pytest
import torch

from portbench.reference import dbg

K, SUB_K, MIN_LEN = 30, 29, 40


def rand(rng, n):
    return "".join("ACGT"[x] for x in rng.integers(0, 4, n))


def planted(case):
    rng = np.random.default_rng(11)
    x = rand(rng, 160)
    end = rand(rng, 32)
    if case == "tip":
        # a read leaving the path: a dead-end chain of 2 (sub_k + 1) - 1
        # bases, long enough to emit, in reach of the slots
        return [x, x[:100] + end[:31]], 8, 512
    if case == "no_tip":
        # one base longer: no tip, emitted
        return [x, x[:100] + end], 8, 512
    if case == "join_end":
        # two paths join and end 46 bases later: dead at the tail, but no
        # predecessor branches, so no tip
        return [x[:100] + x[100:145], rand(rng, 100) + x[100:145]], 8, 512
    if case == "branch":
        return [x, x[:80] + rand(rng, 90), rand(rng, 30) + x[60:]], 4, 512
    if case == "cap_and_ties":
        # six paths of two lengths, more than the 4 slots
        return [rand(rng, n) for n in (70, 70, 70, 90, 90, 55)], 4, 512
    if case == "cycle":
        c = rand(rng, 80)
        return [c + c[:K + 5], rand(rng, 100)], 4, 512
    if case == "cut":
        return [x, rand(rng, 150)], 4, 64
    raise KeyError(case)


def program_unitigs(kset, max_unitigs, max_len):
    from gappadder_tpu_torch.ops import dbg as pdbg
    rows = sorted(kset)
    ks = torch.tensor([["ACGT".index(b) for b in r] for r in rows],
                      dtype=torch.int8)[None]
    useq, ulen, count = pdbg.assemble_unitigs(
        ks, torch.tensor([len(rows)]), k=K, sub_k=SUB_K,
        max_unitigs=max_unitigs, max_len=max_len, min_len=MIN_LEN)
    return [dbg.decode(useq[0, i, :ulen[0, i]].numpy())
            for i in range(int(count[0]))]


@pytest.mark.parametrize("case", ["tip", "no_tip", "join_end", "branch",
                                  "cap_and_ties", "cycle", "cut"])
def test_the_plain_dbg_emits_what_the_program_emits(case):
    reads, mu, max_len = planted(case)
    kset = dbg.kmers(reads, K)
    stats = {}
    want = dbg.unitigs(kset, SUB_K, MIN_LEN, mu, max_len, stats)
    assert want, stats
    assert program_unitigs(kset, mu, max_len) == want
    found, (succ, pred) = dbg.chains(kset, SUB_K)
    if case == "tip":
        tips = [s for s, h, t, _c in found
                if dbg.is_tip(s, h, t, succ, pred, SUB_K)]
        assert [len(t) for t in tips] == [2 * (SUB_K + 1) - 1] * 2
        assert not any(t in want or dbg.revcomp(t) in want for t in tips)
        assert len(want) == 2
    if case in ("no_tip", "join_end"):
        assert stats["tips"] == 0 and len(want) == 3
        assert min(len(u) for u in want) <= 2 * (SUB_K + 1)
    if case == "branch":
        assert stats["branching"] >= 2 and len(want) >= 2
    if case == "cap_and_ties":
        assert stats["eligible"] > mu
    if case == "cycle":
        assert any(c for _s, _h, _t, c in found)
    if case == "cut":
        assert max(len(s) for s, *_ in found) > max_len
        assert all(len(u) <= max_len for u in want)
