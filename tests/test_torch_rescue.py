"""Port parity of the rescue stage (`pipeline/rescue.py`): the SW
verification of seed hits (two local passes, the second on reversed
prefixes), the both-unmapped rescue with its mate recruitment, and the
HQ pseudo-contigs, on the CPU, against the JAX package's on the same
inputs, exactly."""

import numpy as np
import pytest
import torch

from gappadder_tpu.io.fastq import ReadSet as JReadSet
from gappadder_tpu.pipeline import rescue as jrescue
from gappadder_tpu.pipeline.workspace import Workspace as JWorkspace
from gappadder_tpu_torch import dna
from gappadder_tpu_torch.config import Config
from gappadder_tpu_torch.io.fastq import ReadSet
from gappadder_tpu_torch.pipeline import rescue
from gappadder_tpu_torch.pipeline.run import _tuple_from_list
from gappadder_tpu_torch.pipeline.workspace import Workspace


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """One intra-op thread: the plain DPs run thousands of small tensor
    steps, which a pool of threads does not speed up, and the pool's
    waiting threads slow the other test workers on the same cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _readsets(left, right):
    """The same two FASTQ sides as the port's and the JAX package's
    ReadSets; mates share a name hash, row order differs per side."""
    out = []
    for cls in (ReadSet, JReadSet):
        pair = []
        for side in (left, right):
            seqs, hashes = side
            L = max(len(s) for s in seqs)
            seq = np.full((len(seqs), L), dna.N, np.int8)
            for i, s in enumerate(seqs):
                seq[i, :len(s)] = s
            pair.append(cls(seq=seq, length=np.array([len(s) for s in seqs],
                                                     np.int32),
                            qual=np.full(seq.shape, 73, np.uint8),
                            name_hash=np.asarray(hashes, np.uint64),
                            names=[b"r%d" % h for h in hashes]))
        out.append([tuple(pair)])
    return out


def _scenario(rng):
    """Two open gaps, each with contigs cut from its own truth; read
    pairs drawn from the truths (some spanning the contigs' ends, some
    unrelated), mates on the other strand, the right side's rows
    shuffled."""
    truths = [rng.integers(0, 4, 900).astype(np.int8) for _ in range(2)]
    store = {
        3: _tuple_from_list([truths[0][0:330], truths[0][600:900]],
                            ["30_29_0", "30_29_1"]),
        7: _tuple_from_list([truths[1][100:500]], ["40_39_0"]),
    }
    left, right, hashes = [], [], []
    for i in range(40):
        tr = truths[i % 2]
        if i % 9 == 8:
            tr = rng.integers(0, 4, 900).astype(np.int8)
        a = int(rng.integers(0, 560))
        r1 = tr[a:a + 100].copy()
        r2 = dna.revcomp(tr[a + 200:a + 300])
        r1[rng.random(100) < 0.01] = 2
        left.append(r1)
        right.append(r2)
        hashes.append(1000 + i)
    perm = rng.permutation(len(right))
    return store, (left, hashes), ([right[p] for p in perm],
                                   [hashes[p] for p in perm])


def test_verify_hits_matches_jax(rng):
    """Seed-diagonal windows and whole-contig targets, both strands,
    scores around the threshold."""
    store, (left, _), _ = _scenario(rng)
    s, l, n, _ = store[3]
    reads = np.full((len(left), 100), dna.N, np.int8)
    for i, r in enumerate(left):
        reads[i, :len(r)] = r
    rl = np.full(len(left), 100, np.int32)
    pairs5 = [(r, r % 2, c, 3, int(rng.integers(-20, 250)))
              for r in range(len(left)) for c in range(n)]
    pairs3 = [p[:3] for p in pairs5]
    for pairs in (pairs5, pairs3):
        for min_score in (30, 60):
            got = rescue._verify_hits(reads, rl, pairs, s, l, min_score,
                                      device="cpu")
            assert got == jrescue._verify_hits(reads, rl, pairs, s, l,
                                               min_score)
    assert any(v[4] for v in got) and len(got) >= 5


@pytest.mark.parametrize("open_gaps", [[3, 7], [7]])
def test_rescue_both_unmapped_matches_jax(rng, tmp_path, open_gaps):
    store, left, right = _scenario(rng)
    rs, jrs = _readsets(left, right)
    n = len(left[0])
    bu = {"lib": np.zeros(2 * n, np.int32),
          "side": np.repeat(np.array([0, 1], np.int32), n),
          "row": np.tile(np.arange(n, dtype=np.int32), 2)}
    Workspace(str(tmp_path)).save_arrays("both_unmapped", **bu)
    cfg = Config(draft_genome="d.fa")
    got = rescue.rescue_both_unmapped(cfg, Workspace(str(tmp_path)), rs,
                                      store, open_gaps, device="cpu")
    want = jrescue.rescue_both_unmapped(cfg, JWorkspace(str(tmp_path)), jrs,
                                        store, open_gaps)
    assert got == want
    assert all(len(v) > 4 for v in got.values()) and set(got) == \
        set(open_gaps)


def test_hq_pseudo_contigs_match_jax(rng):
    """Reads spanning the junction of two abutting contigs are clipped on
    both and become pseudo-contigs; reads inside one contig do not."""
    truth = rng.integers(0, 4, 700).astype(np.int8)
    store = {0: _tuple_from_list([truth[:360], truth[340:700]],
                                 ["25_21_0", "25_21_1"])}
    left = [truth[a:a + 100] for a in (290, 300, 260, 50, 500, 310)]
    right = [dna.revcomp(x) for x in left]
    hashes = list(range(len(left)))
    rs, jrs = _readsets((left, hashes), (right, hashes))
    entries = [(0, s, r) for r in range(len(left)) for s in (0, 1)]
    cfg = Config(draft_genome="d.fa")
    got = rescue.hq_pseudo_contigs(cfg, 0, store, rs, entries, device="cpu")
    want = jrescue.hq_pseudo_contigs(cfg, 0, store, jrs, entries)
    assert [g.tolist() for g in got] == [w.tolist() for w in want]
    assert len(got) >= 2
    assert rescue.hq_pseudo_contigs(cfg, 0, store, rs, [], device="cpu") \
        == []
