"""Inputs for holding the hand-written kernels against their plain
versions (SW query/target pairs, the sort's cases, the probe kernels'
inputs), the multi-setting DBG's toy batches, and scenarios written as files for the pipeline's stages (the
Assembly driver's workspace, Collect's draft, BAM and FASTQs, the CLI's
JSON config) and the comparison of two workspaces. Used by the tests
and by chip_smoke.py; no pipeline path imports this module."""

from __future__ import annotations

import numpy as np

from . import dna
from .ops.kmers import FULL

# entry_cap of the production step (64 gaps of up to 1000 bp, 100 bp
# reads at step 4): 4 * 64 * 272 recruit entries
PRODUCTION_ENTRY_CAP = 69632
# name -> (shape, num_keys, payloads, key kind): keys and payloads
# 1-4 x 0-2, the k-mer merge rows of k = 30 / 40 / 50 at the production
# gap batch, a DBG node-cap row batch, the DBG join of 4 limbs plus the
# node/query tag (5 keys), the recruit join's 1-D row, rows of N = 0, 1,
# 127 and 4097, rows of FULL keys and of ties, negative keys, and wide
# composite keys above 2^32; and rows around the merge sort's tile size T
# (N = T - 1, T, T + 1, 3T + 1) for its wide tiles (2 keys: T = 2048,
# taken on a 132-SM card when the grid has a block for half the SMs,
# here 140 or 280 tiles) and its narrow tiles (4 keys on a few rows:
# T = 256), the recruit join's one row of 77214 (4 keys + 2 payloads;
# 76 wide tiles, odd run counts on the way up), and the seed matcher's
# single rows near 2^20: the contig k-mer index (2 limbs + contig id and
# position) and the read-to-index join (2 limbs + the index/query tag,
# the row id); and Collect's rows: the recruit join of one library of
# 690,000 read pairs (M + R ~ 1.6 M, 4 keys + 2 payloads; ~1,600 tiles
# of 1024, 11 merge passes) and the interval join of one read batch
# (131,072 reads + 512 padded windows, 3 keys + 1 payload)
SORT_CASES = {
    **{f"k{k}p{p}": ((3, 1000), k, p, "limbs")
       for k in range(1, 5) for p in range(3)},
    "merge_k30": ((64, 38400), 2, 0, "limbs"),
    "merge_k40": ((64, 33280), 3, 0, "limbs"),
    "merge_k50": ((64, 28160), 4, 0, "limbs"),
    "merge_k30_counts": ((64, 38400), 2, 1, "limbs"),
    "node_cap": ((64, 16384), 4, 1, "limbs"),
    "dbg_join_k5": ((64, 16384), 5, 1, "limbs"),
    "entry_cap_1d": ((PRODUCTION_ENTRY_CAP,), 4, 2, "limbs"),
    "n0": ((4, 0), 2, 1, "limbs"),
    "n1": ((4, 1), 2, 1, "limbs"),
    "n127": ((5, 127), 3, 1, "limbs"),
    "n4097": ((2, 4097), 2, 2, "limbs"),
    "n1_1d": ((1,), 1, 1, "limbs"),
    "all_full": ((4, 3000), 2, 1, "full"),
    "all_ties": ((4, 3000), 3, 2, "ties"),
    "negative": ((8, 2500), 2, 1, "signed"),
    "composite_key": ((16, 8192), 1, 1, "wide"),
    **{f"wide_tile{tag}": ((rows, 2048 + d), 2, 1, "limbs")
       for tag, rows, d in (("_m1", 140, -1), ("", 140, 0), ("_p1", 140, 1),
                            ("3_p1", 70, 2 * 2048 + 1))},
    **{f"narrow_tile{tag}": ((3, 256 + d), 4, 1, "limbs")
       for tag, d in (("_m1", -1), ("", 0), ("_p1", 1), ("3_p1", 513))},
    "row_77214_k4p2": ((77214,), 4, 2, "limbs"),
    "row_1m_k2p2": (((1 << 20) - 3,), 2, 2, "limbs"),
    "row_1m_k3p1": (((1 << 20) + 5,), 3, 1, "limbs"),
    "row_1600000_k4p2": ((1_600_000,), 4, 2, "limbs"),
    "row_131584_k3p1": ((131_072 + 512,), 3, 1, "limbs"),
}


def sort_case(name: str, seed: int = 0):
    """The planes and num_keys of SORT_CASES[name], as int64 numpy
    arrays: uint32 limbs drawn from a small pool (so ties are common)
    with FULL rows mixed in, all-FULL or all-equal rows, signed int32
    keys, or wide non-negative keys above 2^32."""
    shape, nk, npay, kind = SORT_CASES[name]
    rng = np.random.default_rng(seed)
    keys = []
    for _ in range(nk):
        if kind == "full":
            k = np.full(shape, FULL, np.int64)
        elif kind == "ties":
            k = np.full(shape, 7, np.int64)
        elif kind == "signed":
            k = rng.integers(-(1 << 31), 1 << 31, shape).astype(np.int64)
            k[..., ::3] = -1
        elif kind == "wide":
            k = rng.integers(0, 1 << 40, shape).astype(np.int64)
        else:
            pool = rng.integers(0, 1 << 32, 64).astype(np.int64)
            k = pool[rng.integers(0, 64, shape)]
            k[rng.random(shape) < 0.2] = FULL
        keys.append(k)
    pays = [rng.integers(-(1 << 31), 1 << 31, shape).astype(np.int64)
            for _ in range(npay)]
    return keys + pays, nk


# name -> a toy batch of the multi-setting DBG
# (ops/dbg.assemble_unitigs_multi), 2 gaps: (kind, settings, rows M of
# each setting's table, gap 1 "empty" or "half" of gap 0's set, keyword
# arguments). "walks": random sequences, a shared stretch and a forced
# cycle at each k; "snp": a single-base error path at count 1 beside the
# truth at count 8 (no counts otherwise). two_groups: settings in two
# occurrence-row groups; mixed_limbs: one group mixing k, so the keys
# pad to 3 limbs (sub_k 15 beside 16 and 32), popping without counts;
# snp_pop1/2: one group's settings at different M (coverage rows padded)
# and a second group; caps: raw node and edge counts past the caps
_WALK_KW = dict(max_unitigs=16, max_len=256, min_len=14, pop_bubbles=0,
                node_cap=1024, edge_cap=1024)
_SNP_KW = dict(max_unitigs=16, max_len=256, min_len=10, node_cap=1024,
               edge_cap=1024)
DBG_MULTI_CASES = {
    "two_groups": ("walks", ((17, 16), (17, 14), (21, 20), (21, 18)),
                   (300, 300, 300, 300), "empty", _WALK_KW),
    "mixed_limbs": ("walks", ((16, 15), (17, 16), (33, 32)),
                    (320, 320, 320), "half", dict(_WALK_KW, pop_bubbles=1)),
    "snp_pop1": ("snp", ((21, 20), (21, 19), (33, 16)), (320, 160, 160),
                 "empty", dict(_SNP_KW, pop_bubbles=1)),
    "snp_pop2": ("snp", ((21, 20), (21, 19), (33, 16)), (320, 160, 160),
                 "half", dict(_SNP_KW, pop_bubbles=2)),
    "caps": ("walks", ((17, 16), (17, 14), (21, 20), (21, 18)),
             (300, 300, 300, 300), "half",
             dict(_WALK_KW, node_cap=64, edge_cap=64)),
}


def _bases(rng, n: int) -> str:
    return "".join(np.array(list("ACGT"))[rng.integers(0, 4, n)])


def _canonical(seq: str) -> str:
    return min(seq, dna.decode(dna.revcomp(dna.encode(seq))))


def _walk_kstrings(k: int, seed: int = 1) -> list:
    """The distinct canonical k-strings of three random sequences (one
    sharing a stretch of the first) and a periodic one (period k + 1)
    whose graph is a cycle."""
    rng = np.random.default_rng(seed)
    base = _bases(rng, 120)
    per = _bases(rng, k + 1)
    seqs = [base, base[20:80] + _bases(rng, 40), _bases(rng, 70),
            (per * 5)[:3 * k + 7]]
    return sorted({_canonical(s[i:i + k]) for s in seqs
                   for i in range(len(s) - k + 1)})


def _snp_kstrings(k: int, seed: int = 5):
    """The truth's k-strings at count 8 and those a single-base error
    adds at count 1."""
    rng = np.random.default_rng(seed)
    truth = _bases(rng, 150)
    alt = {"A": "C", "C": "G", "G": "T", "T": "A"}[truth[75]]
    err = truth[:75] + alt + truth[76:]
    kt = [truth[i:i + k] for i in range(len(truth) - k + 1)]
    ke = [s for s in (err[i:i + k] for i in range(len(err) - k + 1))
          if s not in set(kt)]
    return kt + ke, [8] * len(kt) + [1] * len(ke)


def dbg_multi_case(name: str):
    """DBG_MULTI_CASES[name] as numpy inputs: (settings, kstr_list int8
    [2, M, k], nk_list int32 [2], kcnt_list int32 [2, M] or None,
    keyword arguments)."""
    kind, settings, rows, gap1, kw = DBG_MULTI_CASES[name]
    kstr, nk, kcnt = [], [], []
    for (k, _sk), M in zip(settings, rows):
        if kind == "walks":
            ks, cnt = _walk_kstrings(k), None
        else:
            ks, cnt = _snp_kstrings(k)
        assert len(ks) <= M
        arr = np.full((2, M, k), dna.N, np.int8)
        arr[:, :len(ks)] = np.stack([dna.encode(s) for s in ks])
        kstr.append(arr)
        nk.append(np.array([len(ks), 0 if gap1 == "empty" else len(ks) // 2],
                           np.int32))
        if cnt is not None:
            c = np.zeros((2, M), np.int32)
            c[:, :len(ks)] = cnt
            kcnt.append(c)
    return settings, kstr, nk, (kcnt or None), dict(kw)


def sw_test_pairs(seed, B=40, Lq=24, Lt=48):
    """Query/target code pairs for holding SW implementations against
    each other: ragged, partly related pairs plus the edge rows 0-6
    (all-N target, all-N query, poly-A ties, one repeated base, a
    length-0 query, a length-0 target and a full-length pair). B >= 7.

    Returns (q int8 [B, Lq], qlen int32 [B], t int8 [B, Lt], tlen)."""
    rng = np.random.default_rng(seed)
    q = rng.integers(0, 4, (B, Lq)).astype(np.int8)
    t = rng.integers(0, 4, (B, Lt)).astype(np.int8)
    ql = rng.integers(1, Lq + 1, B).astype(np.int32)
    tl = rng.integers(1, Lt + 1, B).astype(np.int32)
    for b in range(B):
        k = int(min(ql[b], tl[b]) // 2)
        if k >= 2:
            off = int(rng.integers(0, tl[b] - k + 1))
            chunk = q[b, :k].copy()
            mut = rng.random(k) < 0.1
            chunk[mut] = rng.integers(0, 4, int(mut.sum()))
            t[b, off:off + k] = chunk
    t[0] = 4
    q[1] = 4
    q[2] = 0
    t[2] = 0
    q[3] = q[3, 0]
    t[3] = q[3, 0]
    ql[4] = 0
    tl[5] = 0
    ql[6], tl[6] = Lq, Lt
    return q, ql, t, tl


# (B, Lq, Lt): query widths around the SW kernel's band sizes (32 lanes
# of R rows, R in {2, 4, 8, 10, 16, 32}) and its one-strip limit of 1024
SW_EDGE_SHAPES = tuple((24, Lq, Lt) for Lq, Lt in (
    (1, 40), (31, 29), (32, 64), (33, 33), (64, 20), (65, 130), (320, 300),
    (1024, 260)))


def sw_edge_pairs(seed, B=24, Lq=33, Lt=40):
    """`sw_test_pairs` plus rows 7-15: targets shorter than a warp (1, 2,
    5, 31 bases), an empty target beside a full query, one-row queries
    and queries one short of Lq. B >= 16."""
    q, ql, t, tl = sw_test_pairs(seed, B, Lq, Lt)
    for r, n in zip(range(7, 11), (1, 2, 5, 31)):
        tl[r] = min(n, Lt)
        ql[r] = Lq
    ql[11], tl[11] = Lq, 0
    ql[12] = ql[13] = 1
    ql[14] = ql[15] = max(Lq - 1, 0)
    tl[13] = tl[15] = Lt
    return q, ql, t, tl


# the probe kernels' inputs: name -> (low, high, dtype) of uniform
# integers, so that the int16 loop's h + 1 wraps (near_int16_max), its
# e - 1 wraps (near_int16_min) and its int16 cast wraps (beyond_int16);
# the argmax loop meets many equal maxima (small_ties) and distinct
# ints that are equal as float32 (float_ties); int16_full spans int16;
# near_int32_max makes swprobe's int32 adds wrap (x + 4, A + 1, the
# sum of A-E)
PROBE_INPUTS = {
    "zeros": (0, 1, np.int32),
    "near_int16_max": (32700, 32768, np.int32),
    "near_int16_min": (-32768, -32700, np.int32),
    "beyond_int16": (-(1 << 20), 1 << 20, np.int32),
    "small_ties": (0, 3, np.int32),
    "float_ties": (-(1 << 29), 1 << 29, np.int32),
    "int16_full": (-(1 << 15), 1 << 15, np.int16),
    "near_int32_max": ((1 << 31) - 200, 1 << 31, np.int32),
}
INT16_LOOP_INPUTS = ("zeros", "near_int16_max", "near_int16_min",
                     "beyond_int16")
ARGMAX_INPUTS = ("zeros", "small_ties", "float_ties")
# swprobe's band edges (S, W): one row; a band of one row a lane with
# lanes past the column (5); R = 3 with lanes past it (33); R = 5 whole
# lanes (100), the script's 136 rows (lane 27 holds one live row) and
# every slot live (160); R = 33 (1024: lane 31 holds one live row); on
# negative inputs (C's clamp at 0 decides) and near INT32_MAX
SWPROBE_SHAPES = ((1, 3), (5, 9), (33, 12), (100, 3), (136, 6), (160, 2),
                  (1024, 2))
SWPROBE_INPUTS = ("near_int16_min", "near_int32_max")


def probe_input(name: str, shape, seed: int = 0) -> np.ndarray:
    """PROBE_INPUTS[name] drawn from numpy's generator at `seed`."""
    lo, hi, dtype = PROBE_INPUTS[name]
    return np.random.default_rng(seed).integers(lo, hi, shape).astype(dtype)


# (B, Lq, Lt): queries longer than one strip of the SW kernel (1024 rows),
# swept in two or three strips
SW_STRIP_SHAPES = ((24, 1025, 90), (24, 1100, 70), (24, 2055, 60))


def sw_strip_pairs(seed, B=24, Lq=1100, Lt=70):
    """`sw_edge_pairs` plus rows 16-23 around the strip edge (query rows
    1024 | 1025): row 16 holds a 20-base motif M' ending at query row
    1000 and M ending at row 1025 against the target M + 10 random + M',
    two cells of equal score of which the second strip's has the lower
    d; row 17 the same with M ending at row 1024 and M' at 1045 where
    the query holds it (the first strip's cell has the lower d); rows
    18-19 two-letter pairs (ties everywhere); rows 20-22 poly-A queries
    of 1023, 1024 and 1025 rows against poly-A targets (fit mode's one
    candidate row at the edge); row 23 a query of Lq rows against a
    target of one base. Lq >= 1025, Lt >= 60, B >= 24."""
    q, ql, t, tl = sw_edge_pairs(seed, B, Lq, Lt)
    rng = np.random.default_rng(seed + 1)
    m = 20
    for r, end, end2 in ((16, 1025, 1000), (17, 1024, 1045)):
        mot, mot2 = (rng.integers(0, 4, m).astype(np.int8) for _ in range(2))
        q[r] = rng.integers(0, 4, Lq)
        q[r, end - m:end] = mot
        if end2 <= Lq:
            q[r, end2 - m:end2] = mot2
        t[r] = rng.integers(0, 4, Lt)
        t[r, :m] = mot
        t[r, 2 * m:3 * m] = mot2
        ql[r], tl[r] = Lq, 3 * m
    for r in (18, 19):
        q[r] = rng.integers(0, 2, Lq)
        t[r] = rng.integers(0, 2, Lt)
        ql[r], tl[r] = Lq - (r - 18) * 7, Lt - (r - 18) * 3
    for r, n in zip((20, 21, 22), (1023, 1024, 1025)):
        q[r] = 0
        t[r] = 0
        ql[r], tl[r] = n, Lt
    ql[23], tl[23] = Lq, 1
    return q, ql, t, tl


# query rows at the Evaluate kernel's strip edges (strips of 1024 rows)
EVAL_STRIP_ROWS = (1024, 1025, 2049)


def refine_test_items(seed, n_gaps=8, lmin=400, lmax=2600, win=(150, 1300)):
    """Gaps for the contig refine (`pipeline/run.refine_contigs_multi`):
    per gap, a truth of lmin..lmax bases cut into windows of `win`
    bases that overlap by 40-90, some reverse complemented, one with an
    N run, plus an exact duplicate, a contained piece and an unrelated
    contig. Returns [(contigs, names)] a gap, the contigs shuffled."""
    from .dna import revcomp
    rng = np.random.default_rng(seed)
    items = []
    for g in range(n_gaps):
        L = int(rng.integers(lmin, lmax + 1))
        truth = rng.integers(0, 4, L).astype(np.int8)
        contigs, lo = [], 0
        while lo < L - 100:
            hi = min(L, lo + int(rng.integers(win[0], win[1] + 1)))
            contigs.append(truth[lo:hi].copy())
            lo = hi - int(rng.integers(40, 91))
        contigs[0][len(contigs[0]) // 2:][:5] = 4
        contigs = [revcomp(c) if rng.random() < 0.3 else c for c in contigs]
        contigs.append(contigs[-1].copy())
        piece = contigs[0][10:10 + max(len(contigs[0]) // 3, 20)].copy()
        contigs += [piece, rng.integers(0, 4, 300).astype(np.int8)]
        order = rng.permutation(len(contigs))
        items.append(([contigs[i] for i in order],
                      [f"g{g}_c{i}" for i in range(len(contigs))]))
    return items


def evaluate_test_pairs(seed, count=40, lmin=5, lmax=300, long_rows=(),
                        long_cols=90, tiny=400, log_lengths=False):
    """Ragged (s1, s2) code pairs for holding Evaluate implementations
    against each other, shuffled out of length order: `count` random
    pairs of lmin..lmax bases (uniform, or log-uniform with
    `log_lengths`; every other one a suffix/prefix overlap,
    some with an error, some a containment, some with N runs), the tie
    and edge pairs (lengths 0 and 1, all-N, poly-A, two-letter ACAC...
    runs, a pair shorter than any clip), `tiny` pairs of 1-10 bases of
    two or three letters (where the pointer preference and the scan's
    tie rules decide the winner and its flags), and for each n in
    `long_rows` a
    query of n rows against `long_cols` columns: an overlap ending on the
    last row, and a two-letter pair whose ties straddle the strip
    edge."""
    rng = np.random.default_rng(seed)

    def rand(n, k=4):
        return rng.integers(0, k, n).astype(np.int8)

    empty = np.zeros(0, np.int8)
    pairs = [(rand(1), rand(1)), (rand(1), rand(40)), (rand(40), rand(1)),
             (empty, rand(5)), (rand(5), empty), (rand(3), rand(4)),
             (np.full(30, 4, np.int8), np.full(45, 4, np.int8)),
             (np.full(20, 4, np.int8), rand(20)),
             (np.zeros(60, np.int8), np.zeros(25, np.int8)),
             (np.tile(np.int8([0, 1]), 40), np.tile(np.int8([0, 1]), 33)),
             (np.tile(np.int8([0, 1]), 35)[1:], np.tile(np.int8([1, 0]), 50))]
    for i in range(count):
        if log_lengths:
            n, m = (int(x) for x in np.exp(rng.uniform(
                np.log(lmin), np.log(lmax + 1), 2)))
        else:
            n, m = (int(x) for x in rng.integers(lmin, lmax + 1, 2))
        s1, s2 = rand(n), rand(m)
        if i % 2 == 0 and min(n, m) > 4:
            k = int(rng.integers(4, min(n, m)))
            s2[:k] = s1[-k:]
            if rng.random() < 0.3:
                s2[int(rng.integers(0, k))] ^= 1
        elif i % 6 == 1 and m > n + 2:
            at = int(rng.integers(0, m - n))
            s2[at:at + n] = s1
        if i % 7 == 3:
            s1[-3:] = 4
            s2[:3] = 4
        pairs.append((s1, s2))
    for i in range(tiny):
        k = 2 + i % 2
        n, m = (int(x) for x in rng.integers(1, 11, 2))
        pairs.append((rand(n, k), rand(m, k)))
    for n in long_rows:
        s1, s2 = rand(n), rand(long_cols)
        k = long_cols // 2
        s2[:k] = s1[-k:]
        pairs.append((s1, s2))
        pairs.append((rand(n, 2), rand(long_cols, 2)))
    return [pairs[i] for i in rng.permutation(len(pairs))]


# query rows at Pick's traceback kernel's band edges (32 lanes of R
# rows, R in {1, 2, 4, 6, 8, 10, 12, 16}: R = 1 up to 32 rows, 10 at the
# flanks' 300, 16 from 385) and past its strips of 512 rows
TRACEBACK_ROWS = (1, 31, 32, 33, 64, 65, 300, 320, 321, 384, 385, 512)
TRACEBACK_STRIP_ROWS = (513, 1100)


def traceback_winners(seed, mode: str, rows=TRACEBACK_ROWS, cols=(60, 140),
                      tiny=120, mid=40, dels=40):
    """A pass's winning hits for holding Pick's traceback kernel
    (csrc/traceback.cu) to `sw_host.alignment_stats_batch`, shuffled
    out of length order, as `pick.align_flanks_to_contigs` hands them
    over: for each n in `rows` a query of n rows against a target of
    `cols` bases holding a copy of part of it with a substitution, an
    insertion and a deletion, one or two spans of the target masked to
    N as a later pass masks reported hits, twice: ending at the mode's
    best cell and at a random cell; past 600 rows, a target that skips
    30 query rows around each multiple of 512, so the best path's
    insertion crosses a strip edge; repeats that tie the diagonal
    against E or F (poly-A runs with an indel, two-letter tandem repeats
    with an indel); in `fit` mode queries that start with a run of N or
    of bases the target lacks before its copy at the target's start, so
    the path starts with insertions down column 0; ends on row or
    column 0; `tiny` pairs of 1-10 bases and `mid` pairs of 10-30 bases
    of two or three letters ending at random cells, and `dels` two-letter
    targets of 30 bases whose query lacks 1-4 of them, ending at the best
    cell (where the tie rules decide the path, a gap's opening against
    its extension too), and small pairs whose path turns on that last
    rule, across a strip edge too.

    Returns (q int8 [B, Lq], ql int32 [B], t int8 [B, Lt], tl, qend
    int32 [B], tend)."""
    from .ops.sw_host import BWA_PARAMS, sw_np
    rng = np.random.default_rng(seed)

    def rand(n, k=4):
        return rng.integers(0, k, n).astype(np.int8)

    def best(q, t):
        _, qe, te, _ = sw_np(q, t, BWA_PARAMS, mode)
        return qe, te

    def anywhere(q, t):
        return (int(rng.integers(0, len(q) + 1)),
                int(rng.integers(0, len(t) + 1)))

    items = []   # (q, t, qend, tend)
    for n in rows:
        q = rand(n)
        t = rand(int(rng.integers(*cols)))
        k = min(n, len(t) - 8)
        if k > 6:
            chunk = q[n - k:].copy()
            chunk[k // 3] = (chunk[k // 3] + 1) % 4
            chunk = np.concatenate([chunk[:k // 2], rand(1),
                                    chunk[k // 2:-3], chunk[-2:]])
            at = int(rng.integers(0, len(t) - len(chunk) + 1))
            t[at:at + len(chunk)] = chunk[:len(t) - at]
        for _ in range(int(rng.integers(1, 3))):
            lo = int(rng.integers(0, len(t)))
            t[lo:lo + int(rng.integers(1, 12))] = dna.N
        items.append((q, t, *best(q, t)))
        items.append((q, t, *anywhere(q, t)))
        for e in range(512, n - 60, 512):
            t = np.concatenate([q[e - 60:e - 15], q[e + 15:e + 60]])
            items.append((q, t, *best(q, t)))
    runs = [(np.zeros(30, np.int8), np.concatenate(
                [np.zeros(24, np.int8), [1], np.zeros(9, np.int8)])),
            (np.concatenate([np.zeros(12, np.int8), [2], np.zeros(12,
                                                                  np.int8)]),
             np.zeros(40, np.int8)),
            (np.tile(np.int8([0, 1]), 20)[1:], np.tile(np.int8([0, 1]), 28)),
            (np.tile(np.int8([0, 1, 2]), 14),
             np.concatenate([np.tile(np.int8([0, 1, 2]), 6),
                             np.tile(np.int8([0, 1, 2]), 9)[2:]]))]
    for q, t in runs:
        items.append((q, t, *best(q, t)))
        items.append((q, t, len(q), len(t)))
    if mode == "fit":
        for head in (np.full(5, dna.N, np.int8), np.full(3, 3, np.int8),
                     np.full(9, dna.N, np.int8)):
            t = rand(70)
            t[t == 3] = 2
            q = np.concatenate([head, t[:40]])
            items.append((q, t, *best(q, t)))
        t = rand(70)
        t[:6] = dna.N
        q = np.concatenate([np.full(4, dna.N, np.int8), t[6:50]])
        items.append((q, t, *best(q, t)))
    q, t = rand(40), rand(50)
    items += [(q, t, 0, 20), (q, t, 17, 0), (q, t, 0, 0)]
    for i in range(tiny + mid):
        k = 2 + i % 2
        lo, hi = (1, 11) if i < tiny else (10, 31)
        q, t = rand(int(rng.integers(lo, hi)), k), rand(
            int(rng.integers(lo, hi)), k)
        items.append((q, t, *anywhere(q, t)))
    def bits(x: str):
        return np.array([int(c) for c in x], np.int8)

    # paths that turn on a gap's extension against its opening, each
    # with its end cell (under unit scores in local and fit mode, under
    # bwa's in fit mode; found by a search over small pairs), and past
    # 512 rows one whose insertion extends across the strip edge at row
    # 512 from a cell where opening would start elsewhere (unit scores,
    # local mode: the N rows above it keep H at 0)
    for qs, ts, qe, te in (("110001", "01000101", 5, 7),
                           ("10101", "1010001010", 4, 7),
                           ("000000101", "110001011110100", 9, 12)):
        items.append((bits(qs), bits(ts), qe, te))
    if max(rows) > 512:
        q = np.concatenate([np.full(492, dna.N, np.int8),
                            bits("110110011001110000001110")])
        items.append((q, bits("1101100101000000110100110110"), 513, 7))
    for _ in range(dels):
        t = rand(30, 2)
        at = int(rng.integers(3, 27))
        q = np.concatenate([t[:at], t[at + int(rng.integers(1, 5)):]])
        items.append((q, t, *best(q, t)))
    items = [items[i] for i in rng.permutation(len(items))]
    B = len(items)
    Lq = max(len(x[0]) for x in items)
    Lt = max(len(x[1]) for x in items)
    q = np.full((B, Lq), dna.N, np.int8)
    t = np.full((B, Lt), dna.N, np.int8)
    for b, (qb, tb, _, _) in enumerate(items):
        q[b, :len(qb)] = qb
        t[b, :len(tb)] = tb
    ql = np.array([len(x[0]) for x in items], np.int32)
    tl = np.array([len(x[1]) for x in items], np.int32)
    qend = np.array([x[2] for x in items], np.int32)
    tend = np.array([x[3] for x in items], np.int32)
    return q, ql, t, tl, qend, tend


def driver_workspace(root, args, rowtab, hold_back=(), step: int = 4):
    """Write the Assembly+Pick driver's inputs for the scenario of
    `parallel.slice.example_data` into a Workspace at `root`, as Collect
    would leave them: gaps.npz (scaffold 0, numbers from 1, start/end,
    the flanks and their lengths), recruits.npz (gap, side, lib, row, hq;
    every read of a gap's `rowtab` row, high quality) and
    both_unmapped.npz (lib, side, row). The reads lying wholly inside
    each gap of `hold_back` are moved from its recruits to the
    both-unmapped pairs, so that round 1 cannot close it and rescue
    must bring them back.

    Returns (ws, rec, readsets, fills, held): the Workspace, the recruit
    columns, the one library's read sets, the planted bases of each gap
    (`example_fills`) and the number of reads held back from each gap of
    `hold_back`."""
    from .parallel import slice as sl
    from .pipeline.workspace import Workspace
    readsets, per_gap, gaps = sl.example_reads(args, rowtab)
    fills = sl.example_fills(args, per_gap, step)
    read_len = np.asarray(args[22]).shape[1]
    margin = read_len - 8
    G = len(per_gap)
    glen = np.asarray(args[17]) - np.asarray(args[16])
    rec = {k: [] for k in ("gap", "side", "lib", "row", "hq")}
    bu = {k: [] for k in ("lib", "side", "row")}
    held = {}
    for g, rows in enumerate(per_gap):
        for i, (lib, side, row) in enumerate(sorted(rows)):
            a = i * step - margin          # read start, gap-relative
            if g in hold_back and a >= 0 and a + read_len <= glen[g]:
                held[g] = held.get(g, 0) + 1
                for k, v in zip(("lib", "side", "row"), (lib, side, row)):
                    bu[k].append(v)
                continue
            for k, v in zip(("gap", "side", "lib", "row", "hq"),
                            (g, side, lib, row, 1)):
                rec[k].append(v)
    rec = {k: np.asarray(v, np.int32) for k, v in rec.items()}
    ws = Workspace(str(root))
    fl, fr = gaps["flank_left"], gaps["flank_right"]
    ws.save_arrays(
        "gaps", scaffold=np.zeros(G, np.int32),
        number=np.arange(1, G + 1, dtype=np.int32),
        start=gaps["start"], end=gaps["end"], flank_left=fl, flank_right=fr,
        flank_left_len=np.full(G, fl.shape[1], np.int32),
        flank_right_len=np.full(G, fr.shape[1], np.int32))
    ws.save_arrays("recruits", **rec)
    ws.save_arrays("both_unmapped",
                   **{k: np.asarray(v, np.int32) for k, v in bu.items()})
    return ws, rec, readsets, fills, held


# the driver's open-gap scenario: one scaffold of 3000 bp with a 600 bp
# gap in its middle, 300 read pairs of 100 bp (insert 300 +- 30), the
# both-unmapped pairs cut to those left of the gap's middle, so that
# rescue and round 2 run and cannot close it and the relaxed final
# pick's extension does. Error-free reads leave HQ nothing to build
# (every read lies whole in a contig); with 0.1 % of the read bases
# substituted, the contigs break at the errors and HQ turns the
# flank-anchored reads clipped on two of them into pseudo-contigs
OPEN_GAP = dict(gap_len=600, L=3000, n_pairs=300)
OPEN_GAP_READ_ERRORS = 0.001


def _simulate_pairs(truth: str, gap_spans, n_pairs: int, rng,
                    read_len: int = 100, insert: int = 300, std: int = 30,
                    err_rate: float = 0.0):
    """FR read pairs sampled from `truth` and the BAM records a mapper
    leaves against the draft (the truth with `gap_spans` as Ns): a read
    over a gap edge soft-clipped on the gap side (unmapped below
    MIN_ANCHOR bases), a read inside a gap unmapped at its mate's place,
    a pair inside a gap unplaced (flag 12). Draws from `rng` in
    tests/read_simulator.py's order, so one seed gives its files.
    Returns (records, left FASTQ entries, right FASTQ entries)."""
    from . import dna
    gs, ge = (np.array(v, dtype=np.int64) for v in zip(*sorted(gap_spans)))

    def align(a):
        """(pos, CIGAR) of the read at a, or None where it is unmapped."""
        mapped, pos, lclip, rclip = _place(a, read_len, gs, ge)
        if not mapped:
            return None
        clip = [("S", int(lclip))] if lclip else []
        return int(pos), clip + [("M", int(read_len - lclip - rclip))] + (
            [("S", int(rclip))] if rclip else [])

    def mutate(seq):
        if err_rate <= 0:
            return seq
        arr = dna.encode(seq).copy()
        for p in np.nonzero(rng.random(len(arr)) < err_rate)[0]:
            arr[p] = (arr[p] + rng.integers(1, 4)) % 4
        return dna.decode(arr)

    T = dna.encode(truth)
    L = len(T)
    recs, left, right = [], [], []
    for i in range(n_pairs):
        ins = int(np.clip(rng.normal(insert, std), 2 * read_len + 2, L - 2))
        p = int(rng.integers(0, L - ins))
        a1, a2 = p, p + ins - read_len
        seq1 = mutate(dna.decode(T[a1:a1 + read_len]))
        seq2 = mutate(dna.decode(dna.revcomp(T[a2:a2 + read_len])))
        name = f"p{i}"
        left.append((name + "/1", seq1))
        right.append((name + "/2", seq2))
        m1, m2 = align(a1), align(a2)
        flag1, flag2 = 0x1 | 0x40 | 0x20, 0x1 | 0x80 | 0x10
        if m1 is None:
            flag1 |= 0x4
            flag2 |= 0x8
        if m2 is None:
            flag2 |= 0x4
            flag1 |= 0x8
        pos1 = m1[0] if m1 else (m2[0] if m2 else None)
        pos2 = m2[0] if m2 else (m1[0] if m1 else None)
        if pos1 is None:
            for fl, sq in ((flag1, seq1), (flag2, seq2)):
                recs.append(dict(name=name, flag=fl, tid=-1, pos=-1, mapq=0,
                                 cigar=[], mtid=-1, mpos=-1, tlen=0, seq=sq))
            continue
        recs.append(dict(name=name, flag=flag1, tid=0, pos=pos1,
                         mapq=60 if m1 else 0, cigar=m1[1] if m1 else [],
                         mtid=0, mpos=pos2, tlen=ins, seq=seq1))
        recs.append(dict(name=name, flag=flag2, tid=0, pos=pos2,
                         mapq=60 if m2 else 0, cigar=m2[1] if m2 else [],
                         mtid=0, mpos=pos1, tlen=-ins, seq=seq2))
    recs.sort(key=lambda r: r["pos"])
    return recs, left, right


def gap_scenario(root, seed: int = 0, gap_len: int = 150, L: int = 2400,
                 n_pairs: int = 500, err_rate: float = 0.0):
    """tests/test_end_to_end.py's one-gap scenario written with the port
    alone: a scaffold of L seeded bases with a gap of `gap_len` Ns in
    its middle (draft.fa), one paired library (lib.bam, lib_1.fastq,
    lib_2.fastq) and its Config, its working folder `root`/work. Numpy's
    generator at `seed` draws what that test's `rng` fixture draws, so
    the files are the ones it writes. Returns (cfg, truth, (gs, ge))."""
    import os
    from .config import Config, Library, TpuParams
    from .io import bam as bam_io
    from .io import fasta as fasta_io
    rng = np.random.default_rng(seed)
    os.makedirs(root, exist_ok=True)
    truth = "".join(np.array(list("ACGT"))[rng.integers(0, 4, L)])
    gs = L // 2 - gap_len // 2
    ge = gs + gap_len
    draft_path = os.path.join(root, "draft.fa")
    fasta_io.write_fasta(draft_path,
                         [("scaf0", truth[:gs] + "N" * gap_len + truth[ge:])])
    recs, left, right = _simulate_pairs(truth, [(gs, ge)], n_pairs, rng,
                                        err_rate=err_rate)
    bam = os.path.join(root, "lib.bam")
    bam_io.write_bam(bam, [("scaf0", L)], recs)
    fqs = [os.path.join(root, f"lib_{m}.fastq") for m in (1, 2)]
    for path, entries in zip(fqs, (left, right)):
        with open(path, "w") as fh:
            for name, seq in entries:
                fh.write(f"@{name}\n{seq}\n+\n{'I' * len(seq)}\n")
    cfg = Config(
        draft_genome=draft_path, min_gap_size=50, flank_length=150,
        working_folder=os.path.join(root, "work"), kmers=((25, 21), (31, 27)),
        min_kmer_count=0,
        libraries=(Library(bam=bam, insert_size=300, std=30, left_fq=fqs[0],
                           right_fq=fqs[1]),),
        tpu=TpuParams(read_batch=1 << 12, use_pallas=False))
    return cfg, truth, (gs, ge)


def keep_left_pairs(ws, readsets, truth: str, upto: int) -> int:
    """Keep in the workspace's both_unmapped.npz only the pairs whose
    two reads both end at or before truth position `upto` (each read
    placed by exact search on either strand). Returns the entries
    kept."""
    from . import dna
    rc = dna.decode(dna.revcomp(dna.encode(truth)))

    def end(li, side, row):
        r = dna.decode(readsets[li][side].get_seq(row))
        p = truth.find(r)
        if p < 0:
            p = len(truth) - rc.find(r) - len(r)
        return p + len(r)

    bu = ws.load_arrays("both_unmapped")
    keep = np.array([max(end(li, 0, row), end(li, 1, row)) <= upto
                     for li, row in zip(bu["lib"], bu["row"])], bool)
    ws.save_arrays("both_unmapped", **{k: v[keep] for k, v in bu.items()})
    return int(keep.sum())


def open_gap_workspace(root, seed: int = 0, err_rate: float = 0.0,
                       device="cpu"):
    """The open-gap driver scenario (OPEN_GAP, reads substituted at
    `err_rate`) through the port's Preprocess and Collect on `device`,
    its both-unmapped pairs cut to those left of the gap's middle: the
    workspace the Assembly stage starts from (recruits.npz and the
    FASTQs, as `-c Assembly` does). Returns (cfg, Workspace, truth,
    (gs, ge), pairs kept)."""
    from .io import fasta as fasta_io
    from .pipeline import collect, preprocess
    from .pipeline.workspace import Workspace
    cfg, truth, (gs, ge) = gap_scenario(root, seed, err_rate=err_rate,
                                        **OPEN_GAP)
    ws = Workspace(cfg.workdir)
    genome = fasta_io.read_fasta(cfg.draft_genome)
    preprocess.run_preprocess(cfg, ws, genome=genome, device=device)
    _rec, readsets = collect.run_collect(cfg, ws, genome=genome,
                                         device=device)
    kept = keep_left_pairs(ws, readsets, truth, (gs + ge) // 2)
    return cfg, ws, truth, (gs, ge), kept


# Collect's chip scenario: E. coli K-12 MG1655's size (4.64 Mbp) as 8
# scaffolds of 575 kb with 8 gaps each (100-400 bp), and the reference's
# two libraries (its configuration.json): paired ends of 300 +- 50 at
# 30x and mate pairs of 30,000 +- 1,000 at 5x, 100 bp reads
COLLECT_LIBRARIES = ((300, 50, 100, 30.0), (30_000, 1_000, 100, 5.0))
PRODUCTION_KSET = ((30, 29), (30, 27), (40, 39), (40, 37), (50, 49),
                   (50, 47))
MIN_ANCHOR = 20         # a read needs 20 aligned bases beside a gap


def _place(a, read_len, gs, ge):
    """Where a mapper puts reads [a, a + read_len) (global coordinates)
    against the gaps [gs, ge) (global, sorted): (mapped, pos, lclip,
    rclip), pos global. A read overlapping a gap edge is soft-clipped on
    the gap side when the longer anchor has MIN_ANCHOR bases, else it is
    unmapped, as is a read wholly inside a gap."""
    b = a + read_len
    j = np.searchsorted(ge, a, side="right")
    jc = np.minimum(j, len(gs) - 1)
    ov = (j < len(gs)) & (gs[jc] < b)
    left = np.maximum(gs[jc] - a, 0)
    right = np.maximum(b - ge[jc], 0)
    lkeep = ov & (left >= MIN_ANCHOR) & (left >= right)
    rkeep = ov & ~lkeep & (right >= MIN_ANCHOR)
    mapped = ~ov | lkeep | rkeep
    pos = np.where(rkeep, ge[jc], a)
    lclip = np.where(rkeep, read_len - right, 0)
    rclip = np.where(lkeep, read_len - left, 0)
    return mapped, pos, lclip, rclip


def _fastq_bytes(names, seq, qual, mate: int) -> bytes:
    """FASTQ records '@<name>/<mate>', fixed-width names and reads, built
    as one byte array (no loop over reads)."""
    n, L = seq.shape
    w = names.shape[1]
    rec = np.empty((n, 1 + w + 3 + L + 3 + L + 1), np.uint8)
    rec[:, 0] = ord("@")
    rec[:, 1:1 + w] = names
    rec[:, 1 + w:4 + w] = np.frombuffer(f"/{mate}\n".encode(), np.uint8)
    o = 4 + w
    rec[:, o:o + L] = np.frombuffer(b"ACGTN", np.uint8)[seq]
    rec[:, o + L:o + L + 3] = np.frombuffer(b"\n+\n", np.uint8)
    rec[:, o + L + 3:o + 2 * L + 3] = qual
    rec[:, -1] = ord("\n")
    return rec.tobytes()


def collect_scenario(root, seed: int = 0, *, n_scaffolds: int = 8,
                     scaffold_len: int = 575_000, gaps_per_scaffold: int = 8,
                     gap_len=(100, 400), libraries=COLLECT_LIBRARIES,
                     n_open: int = 4, mapq0: float = 0.02,
                     chimeric: float = 0.01, kmers=PRODUCTION_KSET):
    """Write a draft, its BAMs and FASTQs into `root`, as a mapper would
    leave them, and return (Config, truth) for the port's Preprocess ->
    Collect -> Assembly -> Patch chain. Numpy, no loop over reads.

    The truth is seeded random ACGT; the draft is the truth with each
    gap's bases replaced by Ns. Each library (insert, std, read length,
    coverage) samples FR pairs uniformly; `chimeric` of them take their
    second read from another scaffold. A read over a gap edge is
    soft-clipped on the gap side (unmapped below MIN_ANCHOR bases), a
    read inside a gap is unmapped (flag 4, its mate flag 8) and placed at
    its mate, a pair inside a gap is flagged 12; a mapped read has mapq
    60 and an M-only CIGAR, except `mapq0` of them with mapq 0. The
    `n_open` gaps keep no read of any library over their middle 50 bp,
    so no round can close them.

    truth: dict of "scaffolds" (int8 codes a scaffold), "gaps" (G x 3:
    scaffold, local start, local end, in genome order), "open" (gap
    indices), "margin" and "pairs" a library."""
    import os
    from . import dna
    from .config import Config, Library
    from .io import bam as bam_io
    from .io import fasta as fasta_io
    rng = np.random.default_rng(seed)
    os.makedirs(root, exist_ok=True)
    S, L = n_scaffolds, scaffold_len
    truth = rng.integers(0, 4, S * L).astype(np.int8)
    G = S * gaps_per_scaffold
    span = L // gaps_per_scaffold
    centre = (np.arange(gaps_per_scaffold) + 0.5) * span
    glen = rng.integers(gap_len[0], gap_len[1] + 1, G)
    jitter = rng.integers(-span // 4, span // 4 + 1, G)
    local = (np.tile(centre, S) + jitter - glen // 2).astype(np.int64)
    gs = np.repeat(np.arange(S), gaps_per_scaffold) * L + local
    ge = gs + glen
    draft = truth.copy()
    for a, b in zip(gs, ge):
        draft[a:b] = dna.N
    open_gaps = np.sort(rng.choice(G, n_open, replace=False)) if n_open \
        else np.zeros(0, np.int64)
    mid = (gs[open_gaps] + ge[open_gaps]) // 2
    os_, oe = mid - 25, mid + 25
    names = [f"scaffold_{i}" for i in range(S)]
    draft_path = os.path.join(root, "draft.fa")
    fasta_io.write_fasta(draft_path, [(names[i], draft[i * L:(i + 1) * L])
                                      for i in range(S)])

    libs, pairs = [], []
    for li, (insert, std, rl, cov) in enumerate(libraries):
        n = int(round(cov * S * L / (2 * rl)))
        scaf = rng.integers(0, S, n)
        ins = np.clip(np.round(rng.normal(insert, std, n)), 2 * rl + 2,
                      L - 2).astype(np.int64)
        p = (rng.random(n) * (L - ins)).astype(np.int64)
        a1 = scaf * L + p
        a2 = a1 + ins - rl
        chim = rng.random(n) < chimeric
        scaf2 = np.where(chim, (scaf + rng.integers(1, S, n)) % S, scaf)
        a2 = np.where(chim, scaf2 * L + (rng.random(n) * (L - rl)).astype(
            np.int64), a2)
        # no read over the middle 50 bp of an open gap
        keep = np.ones(n, bool)
        for a in (a1, a2):
            j = np.searchsorted(oe, a, side="right")
            jc = np.minimum(j, max(len(os_) - 1, 0))
            if len(os_):
                keep &= ~((j < len(os_)) & (os_[jc] < a + rl))
        a1, a2, scaf, scaf2, ins, chim = (x[keep] for x in
                                          (a1, a2, scaf, scaf2, ins, chim))
        n = len(a1)
        pairs.append(n)
        offs = np.arange(rl)
        seq1 = truth[a1[:, None] + offs]
        seq2 = dna.COMPLEMENT[truth[a2[:, None] + (rl - 1 - offs)]]
        q1, q2 = (rng.integers(53, 74, (n, rl)).astype(np.uint8)
                  for _ in range(2))
        nd = max(6, len(str(n)))
        width = 4 + nd
        digits = (np.arange(n)[:, None] // 10 ** np.arange(nd)[::-1]
                  % 10 + ord("0")).astype(np.uint8)
        nm = np.concatenate([np.broadcast_to(np.frombuffer(
            f"l{li}p_".encode(), np.uint8), (n, 4)), digits], axis=1)

        m1, pos1, lc1, rc1 = _place(a1, rl, gs, ge)
        m2, pos2, lc2, rc2 = _place(a2, rl, gs, ge)
        both = ~m1 & ~m2
        # an unmapped read sits at its mate's place
        t1, t2 = pos1 // L, pos2 // L
        tid1 = np.where(m1, t1, np.where(m2, t2, -1))
        tid2 = np.where(m2, t2, np.where(m1, t1, -1))
        lp1 = np.where(m1, pos1 % L, np.where(m2, pos2 % L, -1))
        lp2 = np.where(m2, pos2 % L, np.where(m1, pos1 % L, -1))
        f1 = 0x1 | 0x40 | 0x20 | np.where(m1, 0, 0x4) | np.where(m2, 0, 0x8)
        f2 = 0x1 | 0x80 | 0x10 | np.where(m2, 0, 0x4) | np.where(m1, 0, 0x8)
        tl = np.where(both | chim, 0, ins)
        mq1 = np.where(m1 & (rng.random(n) >= mapq0), 60, 0)
        mq2 = np.where(m2 & (rng.random(n) >= mapq0), 60, 0)
        cols = dict(
            flag=np.concatenate([f1, f2]), tid=np.concatenate([tid1, tid2]),
            pos=np.concatenate([lp1, lp2]), mapq=np.concatenate([mq1, mq2]),
            mtid=np.concatenate([tid2, tid1]), mpos=np.concatenate([lp2, lp1]),
            tlen=np.concatenate([tl, -tl]),
            lclip=np.concatenate([np.where(m1, lc1, 0), np.where(m2, lc2, 0)]),
            rclip=np.concatenate([np.where(m1, rc1, 0), np.where(m2, rc2, 0)]))
        # coordinate-sorted, unplaced pairs last
        key = np.where(cols["tid"] < 0, S * L, cols["tid"] * L + cols["pos"])
        order = np.argsort(key, kind="stable")
        both_names = np.concatenate([nm, nm])[order]
        bam = os.path.join(root, f"lib{li}.bam")
        bam_io.write_bam_columns(
            bam, [(x, L) for x in names],
            names=list(both_names.view(f"S{width}").reshape(-1)),
            **{k: v[order].astype(np.int32) for k, v in cols.items()},
            seq=np.concatenate([seq1, seq2])[order],
            lens=np.full(2 * n, rl, np.int32),
            qual=np.concatenate([q1, q2])[order])
        fq = []
        for mate, (sq, q) in ((1, (seq1, q1)), (2, (seq2, q2))):
            fq.append(os.path.join(root, f"lib{li}_{mate}.fastq"))
            with open(fq[-1], "wb") as fh:
                fh.write(_fastq_bytes(nm, sq, q, mate))
        libs.append(Library(bam=bam, insert_size=insert, std=std,
                            left_fq=fq[0], right_fq=fq[1]))

    cfg = Config(draft_genome=draft_path, libraries=tuple(libs),
                 kmers=tuple(kmers), working_folder=os.path.join(root, "work"),
                 min_gap_size=100, flank_length=300)
    gaps = np.stack([gs // L, gs % L, ge - (gs // L) * L], axis=1)
    return cfg, {"scaffolds": [truth[i * L:(i + 1) * L] for i in range(S)],
                 "gaps": gaps, "open": [int(g) for g in open_gaps],
                 "margin": cfg.flank_margin, "pairs": pairs}


def config_dict(cfg) -> dict:
    """A Config as the reference-schema JSON the CLI loads, with every
    field `config.config_from_dict` reads (paths as given, so absolute
    paths load unchanged). Settings that share a k must be adjacent in
    `cfg.kmers`, as the schema groups sub-ks under their k."""
    import dataclasses
    kmers: list = []
    for k, sub in cfg.kmers:
        if not kmers or kmers[-1]["k"] != k:
            kmers.append({"k": k, "k_velvet": []})
        kmers[-1]["k_velvet"].append({"k": sub})
    params = {f: getattr(cfg, f) for f in (
        "min_gap_size", "flank_length", "nthreads", "anchor_mapq",
        "clip_dist", "flank_margin", "long_insert_threshold",
        "high_quality_mapq", "min_contig_len", "min_kmer_count",
        "bubble_pop_rounds", "max_reads_per_gap", "max_distinct_kmers",
        "max_contig_len", "max_unitigs", "pick_max_hits")}
    params.update(verbose=int(cfg.verbose),
                  working_folder=cfg.working_folder)
    return {
        "draft_genome": {"fa": cfg.draft_genome},
        "alignments": [{"bam": lib.bam, "is": lib.insert_size,
                        "std": lib.std} for lib in cfg.libraries],
        "raw_reads": [{"left": lib.left_fq, "right": lib.right_fq}
                      for lib in cfg.libraries],
        "kmer_length": kmers, "parameters": params,
        "tpu": {k: list(v) if isinstance(v, tuple) else v
                for k, v in dataclasses.asdict(cfg.tpu).items()}}


def same_workspace(root_a, root_b, only=None) -> list[str]:
    """Two workspaces hold the same files with the same contents: the
    .npz files array by array (names, dtypes, shapes, values), the
    manifest without its stages' times, every other file byte for byte;
    metrics.json (the CLI's timings) is left out, present or not. With
    `only` (relative file or folder names), just the files those name
    are compared, and each must name at least one. Raises AssertionError naming
    the first difference; returns the relative file names compared."""
    import json
    import os

    def wanted(n):
        return n != "metrics.json" and (only is None or any(
            n == p or n.startswith(p + os.sep) for p in only))

    def names(root):
        return sorted(n for n in (os.path.relpath(os.path.join(d, f), root)
                                  for d, _, fs in os.walk(root) for f in fs)
                      if wanted(n))
    files = names(root_a)
    missing = [p for p in only or () if not any(
        n == p or n.startswith(p + os.sep) for n in files)]
    if missing:
        raise AssertionError(f"workspace {root_a} holds no {missing}")
    if files != names(root_b):
        raise AssertionError(f"workspace files differ: "
                             f"{sorted(set(files) ^ set(names(root_b)))}")
    for nm in files:
        pa, pb = os.path.join(root_a, nm), os.path.join(root_b, nm)
        if nm.endswith(".npz"):
            with np.load(pa) as za, np.load(pb) as zb:
                if sorted(za.files) != sorted(zb.files) or any(
                        za[k].dtype != zb[k].dtype
                        or za[k].shape != zb[k].shape
                        or not np.array_equal(za[k], zb[k])
                        for k in za.files):
                    raise AssertionError(f"{nm}: arrays differ")
            continue
        if nm == "manifest.json":
            ma, mb = ({name: {k: v for k, v in st.items() if k != "time"}
                       for name, st in json.load(open(p))["stages"].items()}
                      for p in (pa, pb))
            if ma != mb:
                raise AssertionError(f"manifest.json differs: {ma} != {mb}")
            continue
        with open(pa, "rb") as fa, open(pb, "rb") as fb:
            if fa.read() != fb.read():
                raise AssertionError(f"{nm} differs")
    return files
