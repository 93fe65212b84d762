"""Seed-and-extend read->contig matching (counterpart of
gappadder_tpu/ops/seedmatch.py): the bwa-mem replacement for
contig-target alignments.

  1. an exact k-mer index of the contigs (packed limbs + contig id +
     position, lexicographically sorted);
  2. read k-mers (both strands) joined against the index by a
     multi-key sort-merge with a fixed fanout;
  3. (read, contig, strand) candidates deduped and vote-counted (host);
  4. survivors verified with the SW kernel (pipeline/rescue.py).

Steps 1-2 run on the device of their inputs. Both sorts go through
`psort.bitonic_sort` (the hand-written sort on the card) with int64
planes holding the JAX package's uint32 limbs; it is stable, as
`lax.sort` is on the JAX package's CPU backend at these shapes, so a
k-mer that occurs more than `fanout` times in the index keeps the same
last `fanout` rows (contig, then position, ascending) in both packages.
"""

from __future__ import annotations

import numpy as np
import torch

from .. import dna
from . import kmers, psort

FULL = kmers.FULL


def build_index(contig_seq, contig_len, k: int):
    """K-mer index of a contig set.

    Args:
      contig_seq: int8 [C, L]; contig_len: int32 [C] (tensors; the index
        lives on their device).

    Returns dict with sorted tensors: limbs int64 [M, nl] (uint32
    values), contig int32 [M], pos int32 [M] (padded entries have limbs
    FULL / contig -1)."""
    C, L = contig_seq.shape
    dev = contig_seq.device
    limbs, valid = kmers.extract_kmers(contig_seq, contig_len, k)
    P = limbs.shape[1]
    flat = limbs.reshape(C * P, -1)
    ids = torch.arange(C, dtype=torch.int64, device=dev).repeat_interleave(P)
    ids = torch.where(valid.reshape(-1), ids, -1)
    pos = torch.arange(P, dtype=torch.int64, device=dev).repeat(C)
    nl = flat.shape[-1]
    ops = [flat[:, l].contiguous() for l in range(nl)] + [ids, pos]
    res = psort.bitonic_sort(tuple(ops), num_keys=nl)
    return {"limbs": torch.stack(res[:nl], dim=-1),
            "contig": res[nl].to(torch.int32),
            "pos": res[nl + 1].to(torch.int32)}


def match_candidates(read_seq, read_len, index_limbs, index_contig,
                     k: int, fanout: int = 4, index_pos=None):
    """Candidate (read, contig, strand) votes via k-mer join, on the
    device of the inputs.

    Returns:
      contig: int32 [N, 2, P, fanout] matched contig ids (-1 none),
        axis 1 = strand (0 fwd, 1 revcomp of read);
      if index_pos is given, also diag: int32 [N, 2, P, fanout] — the
        seed diagonal (contig_pos - read_pos) of each hit."""
    N, L = read_seq.shape
    dev = read_seq.device
    i64 = torch.int64
    rc = dna.revcomp_t(read_seq, read_len)
    both = torch.stack([read_seq, rc], dim=1)            # [N, 2, L]
    limbs, valid = kmers.extract_kmers(
        both, read_len[:, None].expand(N, 2), k)
    P = limbs.shape[-2]
    nl = limbs.shape[-1]
    q = limbs.reshape(N * 2 * P, nl)

    M = index_limbs.shape[0]
    Q = q.shape[0]
    # sort-merge lower bound: position of each query k-mer in the index
    tag = torch.cat([torch.zeros(M, dtype=i64, device=dev),
                     torch.ones(Q, dtype=i64, device=dev)])
    keys = torch.cat([index_limbs, q], dim=0)
    payload = torch.cat([torch.arange(M, dtype=i64, device=dev),
                         torch.arange(Q, dtype=i64, device=dev)])
    ops = [keys[:, l].contiguous() for l in range(nl)] + [tag, payload]
    res = psort.bitonic_sort(tuple(ops), num_keys=nl + 1)
    stag, spay = res[nl], res[nl + 1]
    pos_in_index = torch.cumsum((stag == 0).to(i64), dim=0)
    is_q = stag == 1
    tgt = torch.where(is_q, spay, Q)
    # every index row lands in the dump slot Q, which is cut off
    hi = torch.zeros(Q + 1, dtype=i64, device=dev).scatter_(
        0, tgt, pos_in_index)[:Q]
    # candidates: index rows hi-1-f .. check key equality
    offs = torch.arange(fanout, dtype=i64, device=dev)
    cand = hi[:, None] - 1 - offs[None, :]
    cc = torch.clamp(cand, 0, M - 1)
    eq = torch.ones(cand.shape, dtype=torch.bool, device=dev)
    for l in range(nl):
        eq &= index_limbs[cc, l] == q[:, l][:, None]
    eq &= cand >= 0
    eq &= ~torch.all(q == FULL, dim=-1)[:, None]
    contig = torch.where(eq, index_contig[cc], -1).to(torch.int32)
    if index_pos is None:
        return contig.reshape(N, 2, P, fanout)
    rpos = torch.arange(P, dtype=torch.int32, device=dev).repeat(N * 2)
    diag = torch.where(eq, index_pos[cc] - rpos[:, None], 0).to(torch.int32)
    return (contig.reshape(N, 2, P, fanout),
            diag.reshape(N, 2, P, fanout))


def vote_pairs(contig_votes, min_votes: int = 2, diag_votes=None):
    """Host: dedupe candidates into (read, strand, contig, votes)
    tuples; with diag_votes, (read, strand, contig, votes, diag) where
    diag is the median seed diagonal (contig_pos - read_pos)."""
    cv = _np(contig_votes)
    dv = _np(diag_votes) if diag_votes is not None else None
    N = cv.shape[0]
    out = []
    for r in range(N):
        for s in range(2):
            flat = cv[r, s].reshape(-1)
            ok = flat >= 0
            vals, cnts = np.unique(flat[ok], return_counts=True)
            for c, n in zip(vals, cnts):
                if n < min_votes:
                    continue
                if dv is None:
                    out.append((r, s, int(c), int(n)))
                else:
                    dsel = dv[r, s].reshape(-1)[ok & (flat == c)]
                    out.append((r, s, int(c), int(n),
                                int(np.median(dsel))))
    return out


def _np(x) -> np.ndarray:
    return x.cpu().numpy() if torch.is_tensor(x) else np.asarray(x)
