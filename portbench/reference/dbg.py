"""De-Bruijn unitigs of a gap's reads, in plain Python: the velvet-style
graph GAPPadder assembles each gap with at each (k, sub_k), under the
rules the program documents for its DBG:

  k-strings  the distinct canonical k-mers of the reads (reads with an
             N contribute no k-mer over it)
  nodes      the sub_k-mers of the k-strings and of their reverse
             complements, ordered lexicographically (A < C < G < T)
  edges      the distinct (sub_k + 1)-mers of the same; u -> v with u
             and v an edge's prefix and suffix
  chain      a maximal run of edges u -> v with outdeg(u) == 1 ==
             indeg(v), spelled as its first node and the last base of
             every further node; a chain that closes on itself (a
             cycle) starts at its least node. Both strands of a
             sequence are chains of their own
  tip        a chain dead at one end (its head has no in-edge, or its
             tail no out-edge) whose other end meets a branch (the tail
             has a successor with two or more in-edges, or the head a
             predecessor with two or more out-edges), shorter than
             2 (sub_k + 1): removed
  emitted    of the chains of at least `min_len` bases that are not
             tips, the `max_unitigs` longest, ties to the lesser head
             node; each cut to `max_len` bases; then a chain whose
             reverse complement is lexicographically smaller is
             dropped (its twin stands for it), and a cycle is emitted
             on its lexicographically smaller strand

Nothing here imports the program.
"""

from __future__ import annotations

import numpy as np

_COMP = str.maketrans("ACGT", "TGCA")


def revcomp(s: str) -> str:
    return s.translate(_COMP)[::-1]


def canonical(s: str) -> str:
    return min(s, revcomp(s))


def kmers(reads, k: int) -> set:
    """The distinct canonical k-mers of the reads (strings of ACGTN)."""
    out = set()
    for r in reads:
        for i in range(len(r) - k + 1):
            w = r[i:i + k]
            if "N" not in w:
                out.add(canonical(w))
    return out


def chains(kset, sub_k: int):
    """The graph's chains: (spelled, head, tail, is_cycle) each, and the
    graph as (succ, pred) adjacency lists keyed by node."""
    e = sub_k + 1
    edges = set()
    for s in kset:
        for t in (s, revcomp(s)):
            for i in range(len(t) - e + 1):
                edges.add(t[i:i + e])
    succ, pred = {}, {}
    for x in edges:
        succ.setdefault(x[:-1], []).append(x[1:])
        pred.setdefault(x[1:], []).append(x[:-1])
    nodes = sorted(set(succ) | set(pred))
    nxt = {}
    for u in nodes:
        s = succ.get(u, ())
        if len(s) == 1 and len(pred[s[0]]) == 1:
            nxt[u] = s[0]
    has_prev = {v for u, v in nxt.items() if u != v}
    out, seen = [], set()

    def walk(head):
        path, cur = [head], head
        seen.add(head)
        while cur in nxt and nxt[cur] not in seen:
            cur = nxt[cur]
            path.append(cur)
            seen.add(cur)
        return path
    for n in nodes:
        if n not in has_prev:
            path = walk(n)
            out.append((path, False))
    for n in nodes:                 # what is left lies on cycles
        if n not in seen:
            out.append((walk(n), True))
    return [(p[0] + "".join(x[-1] for x in p[1:]), p[0], p[-1], cyc)
            for p, cyc in out], (succ, pred)


def is_tip(seq, head, tail, succ, pred, sub_k: int) -> bool:
    """A chain dead at one end whose other end meets a branch, shorter
    than 2 (sub_k + 1)."""
    head_dead, tail_dead = not pred.get(head), not succ.get(tail)
    return len(seq) < 2 * (sub_k + 1) and (
        (head_dead and not tail_dead
         and any(len(pred[v]) >= 2 for v in succ[tail]))
        or (not head_dead and tail_dead
            and any(len(succ[u]) >= 2 for u in pred[head])))


def unitigs(kset, sub_k: int, min_len: int, max_unitigs: int,
            max_len: int, stats: dict | None = None) -> list:
    """The emitted unitigs of a set of k-strings, in the program's slot
    order. `stats`, where given, gains counts of the chains, the tips
    removed, the chains eligible, and the branching nodes."""
    found, (succ, pred) = chains(kset, sub_k)
    eligible, tips = [], 0
    for seq, head, tail, cyc in found:
        tip = is_tip(seq, head, tail, succ, pred, sub_k)
        tips += tip
        if len(seq) >= min_len and not tip:
            eligible.append((-len(seq), head, seq, cyc))
    eligible.sort()
    out = []
    for _n, _h, seq, cyc in eligible[:max_unitigs]:
        seq = seq[:max_len]
        rc = revcomp(seq)
        if cyc:
            out.append(min(seq, rc))
        elif seq <= rc:
            out.append(seq)
    if stats is not None:
        for key, v in (("chains", len(found)), ("tips", tips),
                       ("eligible", len(eligible)),
                       ("branching", sum(len(x) >= 2 for x in succ.values())
                        + sum(len(x) >= 2 for x in pred.values()))):
            stats[key] = stats.get(key, 0) + v
    return out


def decode(codes) -> str:
    return np.frombuffer(b"ACGTN", np.uint8)[
        np.clip(np.asarray(codes), 0, 4)].tobytes().decode()
