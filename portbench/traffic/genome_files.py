"""A draft genome with planted gaps, its BAMs and FASTQs, as a mapper
leaves them: the files a finisher hands GAPPadder. Numpy, no loop over
reads, and no import of the program.

A frozen copy of the port's `testcases.collect_scenario` (the same
draws in the same order, so one seed gives the same draft, FASTQs and
alignment records), with writers of its own: the BAM records are
encoded with numpy and deflated in BGZF blocks on a thread pool, and no
.bai index is written (Collect reads the whole file).

`write_scenario` returns the truth beside the paths, and each library's
records in file order with the pair and mate they came from, so that the
reference works from the same inputs as the program.
"""

from __future__ import annotations

import concurrent.futures
import os
import struct
import zlib

import numpy as np

N_CODE = 4
COMPLEMENT = np.array([3, 2, 1, 0, 4, 5], np.int8)
ACGTN = np.frombuffer(b"ACGTN", np.uint8)
MIN_ANCHOR = 20         # a read needs 20 aligned bases beside a gap
BGZF_CHUNK = 0xFF00
BGZF_EOF = bytes.fromhex(
    "1f8b08040000000000ff0600424302001b0003000000000000000000")
# base code -> BAM 4-bit code ("=ACMGRSVTWYHKDBN")
BAM_NIBBLE = np.array([1, 2, 4, 8, 15, 15], np.uint8)
CIGAR_M, CIGAR_S = 0, 4
# record columns a library's records carry, in file order
RECORD_COLUMNS = ("flag", "tid", "pos", "mapq", "mtid", "mpos", "tlen",
                  "lclip", "rclip")


def place(a, read_len, gs, ge):
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


def fastq_bytes(names, seq, qual, mate: int) -> bytes:
    """FASTQ records '@<name>/<mate>', fixed-width names and reads, built
    as one byte array (no loop over reads)."""
    n, L = seq.shape
    w = names.shape[1]
    rec = np.empty((n, 1 + w + 3 + L + 3 + L + 1), np.uint8)
    rec[:, 0] = ord("@")
    rec[:, 1:1 + w] = names
    rec[:, 1 + w:4 + w] = np.frombuffer(f"/{mate}\n".encode(), np.uint8)
    o = 4 + w
    rec[:, o:o + L] = ACGTN[seq]
    rec[:, o + L:o + L + 3] = np.frombuffer(b"\n+\n", np.uint8)
    rec[:, o + L + 3:o + 2 * L + 3] = qual
    rec[:, -1] = ord("\n")
    return rec.tobytes()


def write_fasta(path: str, records, width: int = 80) -> None:
    """(name, int8 codes) records as FASTA, `width` bases a line."""
    with open(path, "wb") as fh:
        for name, codes in records:
            fh.write(b">" + name.encode() + b"\n")
            fh.write(fasta_body(codes, width))


def fasta_body(codes, width: int = 80) -> bytes:
    """A sequence's FASTA lines: `width` bases a line, an empty sequence
    as one empty line."""
    s = ACGTN[np.asarray(codes)]
    n = len(s)
    if n == 0:
        return b"\n"
    full = n // width
    out = np.empty(n + full + (1 if n % width else 0), np.uint8)
    body = out[:full * (width + 1)].reshape(full, width + 1)
    body[:, :width] = s[:full * width].reshape(full, width)
    body[:, width] = ord("\n")
    if n % width:
        out[full * (width + 1):-1] = s[full * width:]
        out[-1] = ord("\n")
    return out.tobytes()


def _reg2bin(beg, end):
    """SAM-spec UCSC bins of [beg, end), vectorised."""
    end = end - 1
    out = np.zeros(len(beg), np.int64)
    done = np.zeros(len(beg), bool)
    for shift, base in ((14, 4681), (17, 585), (20, 73), (23, 9), (26, 1)):
        hit = ~done & ((beg >> shift) == (end >> shift))
        out[hit] = base + (beg[hit] >> shift)
        done |= hit
    return out


def bam_records(names, flag, tid, pos, mapq, mtid, mpos, tlen, lclip, rclip,
                seq, qual) -> bytes:
    """The BAM records of fixed-length reads, encoded with numpy: names
    [n, w] bytes (no mate suffix), seq int8 codes [n, L], qual
    phred+33 [n, L]; a mapped record's CIGAR is [lclip S][M][rclip S],
    an unmapped one has none."""
    n, w = names.shape
    L = seq.shape[1]
    mapped = (flag & 4) == 0
    ops = np.zeros((n, 3), np.uint32)
    nc = np.zeros(n, np.int64)
    mid = L - lclip - rclip
    for want, length, code in ((lclip > 0, lclip, CIGAR_S),
                               (mid > 0, mid, CIGAR_M),
                               (rclip > 0, rclip, CIGAR_S)):
        sel = mapped & want
        rows = np.flatnonzero(sel)
        ops[rows, nc[rows]] = (length[rows].astype(np.uint32) << 4) | code
        nc[rows] += 1
    end = np.where(mapped, pos + np.maximum(mid, 1), pos + 1)
    bins = _reg2bin(np.maximum(pos, 0), np.maximum(end, 1))
    head = np.zeros(n, dtype=[
        ("size", "<i4"), ("ref", "<i4"), ("pos", "<i4"), ("lname", "u1"),
        ("mapq", "u1"), ("bin", "<u2"), ("ncig", "<u2"), ("flag", "<u2"),
        ("lseq", "<i4"), ("mref", "<i4"), ("mpos", "<i4"), ("tlen", "<i4")])
    rec_len = 36 + (w + 1) + 4 * nc + (L + 1) // 2 + L
    head["size"] = rec_len - 4
    head["ref"], head["pos"] = tid, pos
    head["lname"], head["mapq"], head["bin"] = w + 1, mapq, bins
    head["ncig"], head["flag"], head["lseq"] = nc, flag, L
    head["mref"], head["mpos"], head["tlen"] = mtid, mpos, tlen
    Lmax = int(rec_len.max())
    pad = np.zeros((n, Lmax), np.uint8)
    pad[:, :36] = head.view(np.uint8).reshape(n, 36)
    pad[:, 36:36 + w] = names
    o = 36 + w + 1
    codes = BAM_NIBBLE[seq]
    if L % 2:
        codes = np.concatenate([codes, np.zeros((n, 1), np.uint8)], 1)
    packed = (codes[:, 0::2] << 4) | codes[:, 1::2]
    for c in range(4):
        rows = np.flatnonzero(nc == c)
        if not len(rows):
            continue
        if c:
            pad[rows, o:o + 4 * c] = ops[rows, :c].view(np.uint8).reshape(
                len(rows), 4 * c)
        s = o + 4 * c
        pad[rows, s:s + packed.shape[1]] = packed[rows]
        q = s + packed.shape[1]
        pad[rows, q:q + L] = qual[rows] - 33
    keep = np.arange(Lmax)[None, :] < rec_len[:, None]
    return pad[keep].tobytes()


def _bgzf_block(chunk: bytes) -> bytes:
    co = zlib.compressobj(6, zlib.DEFLATED, -15)
    cdata = co.compress(chunk) + co.flush()
    bsize = len(cdata) + 26
    return (b"\x1f\x8b\x08\x04" + b"\x00" * 6 + struct.pack("<H", 6) + b"BC"
            + struct.pack("<HH", 2, bsize - 1) + cdata
            + struct.pack("<II", zlib.crc32(chunk), len(chunk)))


def write_bgzf(path: str, payload: bytes, threads: int = 8) -> None:
    """`payload` as BGZF blocks of BGZF_CHUNK bytes, deflated on
    `threads` threads (zlib releases the interpreter lock)."""
    chunks = [payload[i:i + BGZF_CHUNK]
              for i in range(0, max(len(payload), 1), BGZF_CHUNK)]
    with concurrent.futures.ThreadPoolExecutor(threads) as pool, \
            open(path, "wb") as fh:
        for block in pool.map(_bgzf_block, chunks):
            fh.write(block)
        fh.write(BGZF_EOF)


def write_bam(path: str, refs, records: bytes) -> None:
    """A BAM file of `records` against refs [(name, length)]."""
    head = [b"BAM\x01", struct.pack("<i", 0), struct.pack("<i", len(refs))]
    for name, length in refs:
        nb = name.encode() + b"\x00"
        head += [struct.pack("<i", len(nb)), nb, struct.pack("<i", length)]
    write_bgzf(path, b"".join(head) + records)


def write_scenario(root, seed: int, *, n_scaffolds: int, scaffold_len: int,
                   gaps_per_scaffold: int, gap_len, libraries, n_open: int,
                   mapq0: float, chimeric: float) -> dict:
    """Write a draft, its BAMs and FASTQs into `root`, as a mapper would
    leave them. The truth is seeded random ACGT; the draft is the truth
    with each gap's bases replaced by Ns. Each library (insert, std,
    read length, coverage) samples FR pairs uniformly; `chimeric` of
    them take their second read from another scaffold. A read over a
    gap edge is soft-clipped on the gap side (unmapped below MIN_ANCHOR
    bases), a read inside a gap is unmapped (flag 4, its mate flag 8)
    and placed at its mate, a pair inside a gap is flagged 12; a mapped
    read has mapq 60 and an M-only CIGAR, except `mapq0` of them with
    mapq 0. The `n_open` gaps keep no read of any library over their
    middle 50 bp, so no round can close them.

    Returns a dict: "draft" (path), "names" (scaffold names),
    "scaffolds" (truth codes a scaffold), "draft_codes" (the draft's),
    "gaps" (G x 3: scaffold, local start, local end, in genome order),
    "open" (gap indices), "libraries": one dict each with the paths
    ("bam", "left", "right"), "insert", "std", "pairs", the FASTQ rows'
    "names" [n, w] bytes, "seq" [2, n, L] codes and "qual" [2, n, L],
    and the BAM's records in file order ("records": RECORD_COLUMNS plus
    "pair", the FASTQ row, and "first", mate 1)."""
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
        draft[a:b] = N_CODE
    open_gaps = np.sort(rng.choice(G, n_open, replace=False)) if n_open \
        else np.zeros(0, np.int64)
    mid = (gs[open_gaps] + ge[open_gaps]) // 2
    os_, oe = mid - 25, mid + 25
    names = [f"scaffold_{i}" for i in range(S)]
    draft_path = os.path.join(root, "draft.fa")
    write_fasta(draft_path, [(names[i], draft[i * L:(i + 1) * L])
                             for i in range(S)])

    libs = []
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
        offs = np.arange(rl)
        seq1 = truth[a1[:, None] + offs]
        seq2 = COMPLEMENT[truth[a2[:, None] + (rl - 1 - offs)]]
        q1, q2 = (rng.integers(53, 74, (n, rl)).astype(np.uint8)
                  for _ in range(2))
        nd = max(6, len(str(n)))
        digits = (np.arange(n)[:, None] // 10 ** np.arange(nd)[::-1]
                  % 10 + ord("0")).astype(np.uint8)
        nm = np.concatenate([np.broadcast_to(np.frombuffer(
            f"l{li}p_".encode(), np.uint8), (n, 4)), digits], axis=1)

        m1, pos1, lc1, rc1 = place(a1, rl, gs, ge)
        m2, pos2, lc2, rc2 = place(a2, rl, gs, ge)
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
        recs = {k: v[order].astype(np.int64) for k, v in cols.items()}
        recs["pair"] = np.concatenate([np.arange(n), np.arange(n)])[order]
        recs["first"] = np.concatenate([np.ones(n, bool),
                                        np.zeros(n, bool)])[order]
        seqs = np.stack([seq1, seq2])
        quals = np.stack([q1, q2])
        mate = (~recs["first"]).astype(np.int64)
        bam = os.path.join(root, f"lib{li}.bam")
        write_bam(bam, [(x, L) for x in names], bam_records(
            nm[recs["pair"]], *(recs[k] for k in RECORD_COLUMNS),
            seq=seqs[mate, recs["pair"]], qual=quals[mate, recs["pair"]]))
        fq = []
        for m in (1, 2):
            fq.append(os.path.join(root, f"lib{li}_{m}.fastq"))
            with open(fq[-1], "wb") as fh:
                fh.write(fastq_bytes(nm, seqs[m - 1], quals[m - 1], m))
        libs.append({"bam": bam, "left": fq[0], "right": fq[1],
                     "insert": insert, "std": std, "pairs": n, "names": nm,
                     "seq": seqs, "qual": quals, "records": recs})

    gaps = np.stack([gs // L, gs % L, ge - (gs // L) * L], axis=1)
    return {"draft": draft_path, "names": names,
            "scaffolds": [truth[i * L:(i + 1) * L] for i in range(S)],
            "draft_codes": [draft[i * L:(i + 1) * L] for i in range(S)],
            "gaps": gaps, "open": [int(g) for g in open_gaps],
            "libraries": libs}
