"""Both-unmapped rescue by its rule, in plain numpy and the plain local
Smith-Waterman of `reference/sw.py` (BWA's scoring). Nothing here
imports the program.

The rule (GAPPadder's BothUnmappedReadsCollector: `bwa mem -a -T 30`
of the both-unmapped reads against the round-1 contigs of the gaps
still open): a both-unmapped read joins gap g when its best local
alignment, on either strand, to one of g's contigs scores MIN_SCORE or
more, and its mate joins g with it.

One departure, of the program and not of this file: the program finds
its candidates by seed and vote (19-mers, 2 votes) and aligns a read
only within 64 bases of the seeds' diagonal. On error-free reads, as
the traffic writes them, a read that scores 30 against a contig holds
30 or more bases of it exactly, so 12 or more 19-mers vote on one
diagonal, and the two rules recruit the same reads. This file aligns
every read to every contig.

Each gap's contigs are laid end to end, SEPARATOR Ns apart, as one
target. A local alignment that crosses a separator pays at least 46
for it (one deletion of the 40 bases costs 7 + 39; an N aligned to a
base costs 4), so where it scores s >= 30 its two parts score s + 46
together and one of them alone 38 or more: the best score on the
target reaches 30 exactly where the best on one of its contigs does.
"""

from __future__ import annotations

import numpy as np
import torch

from portbench.reference.sw import local_sw

MIN_SCORE = 30       # bwa mem -T
SEPARATOR = 40       # Ns between two contigs of a gap's target
N_CODE = 4
COMPLEMENT = np.array([3, 2, 1, 0, 4], np.int8)


def gap_target(contigs) -> np.ndarray:
    """A gap's contigs (int8 codes) as one target, SEPARATOR Ns apart."""
    sep = np.full(SEPARATOR, N_CODE, np.int8)
    parts = []
    for c in contigs:
        if parts:
            parts.append(sep)
        parts.append(np.asarray(c, np.int8))
    return np.concatenate(parts) if parts else np.zeros(0, np.int8)


def best_scores(reads, lens, targets, device="cpu",
                lanes: int = 1 << 24) -> np.ndarray:
    """[R, T] the best local score of read r, on either strand, on
    target t. `reads` int8 [R, L] codes, `lens` [R], `targets` a list
    of int8 code arrays. The (read, target) pairs go through `local_sw`
    in chunks of about `lanes` DP cells an anti-diagonal, the targets
    taken by length, each chunk padded to its longest."""
    R, L = reads.shape
    T = len(targets)
    if R == 0 or T == 0:
        return np.zeros((R, T), np.int64)
    rc = np.full_like(reads, N_CODE)
    for i in range(R):
        n = int(lens[i])
        rc[i, :n] = COMPLEMENT[reads[i, :n]][::-1]
    q = torch.from_numpy(np.concatenate([reads, rc])).to(device)
    qlen = torch.from_numpy(np.concatenate([lens, lens]).astype(
        np.int64)).to(device)
    tlen = np.array([len(t) for t in targets], np.int64)
    order = np.argsort(tlen, kind="stable")
    nq = 2 * R                       # strand-major: rows R.. reversed
    per = max(lanes // (L + 1), 1)
    best = np.zeros((T, nq), np.int64)
    for lo in range(0, nq * T, per):
        idx = np.arange(lo, min(lo + per, nq * T))
        qi, tj = idx % nq, order[idx // nq]
        width = max(int(tlen[tj].max()), 1)
        tarr = np.full((len(idx), width), N_CODE, np.int8)
        for k in np.unique(tj):
            tarr[tj == k, :tlen[k]] = targets[k]
        score, _qe, _te = local_sw(
            q[torch.from_numpy(qi).to(device)],
            qlen[torch.from_numpy(qi).to(device)],
            torch.from_numpy(tarr).to(device),
            torch.from_numpy(tlen[tj]).to(device))
        best[tj, qi] = score.cpu().numpy()
    return best.reshape(T, 2, R).max(axis=1).T


def recruit_sets(libraries, entries, gap_contigs: dict, device="cpu"):
    """{gap: set of (lib, side, row)} that the rule recruits.

    `libraries`: each library's FASTQ rows as `genome_files` writes them
    ("seq" [2, n, L] codes; a pair's two reads on one row, so the mate
    of (lib, side, row) is (lib, 1 - side, row)); `entries`: the
    both-unmapped reads (lib, side, row); `gap_contigs`: {gap: [int8
    code arrays]}, the round-1 contigs of the gaps still open."""
    entries = [tuple(int(x) for x in e) for e in entries]
    gaps = [g for g in sorted(gap_contigs) if len(gap_contigs[g])]
    if not entries or not gaps:
        return {}
    L = max(libraries[li]["seq"].shape[2] for li, _s, _r in entries)
    reads = np.full((len(entries), L), N_CODE, np.int8)
    lens = np.zeros(len(entries), np.int64)
    for i, (li, side, row) in enumerate(entries):
        seq = libraries[li]["seq"][side, row]
        reads[i, :len(seq)] = seq
        lens[i] = len(seq)
    scores = best_scores(reads, lens,
                         [gap_target(gap_contigs[g]) for g in gaps], device)
    out: dict = {}
    for i, j in zip(*np.nonzero(scores >= MIN_SCORE)):
        li, side, row = entries[i]
        out.setdefault(gaps[j], set()).update(
            {(li, side, row), (li, 1 - side, row)})
    return out
