"""BAM reading and writing into columnar alignment arrays (counterpart
of gappadder_tpu/io/bam.py, copied: the port imports nothing of the JAX
package).

A BAM file decodes straight into the columnar arrays the classification
consumes. CIGARs collapse to the three quantities the pipeline uses
(left and right clip lengths and the aligned M-sum); read names become
FNV-1a hashes for the joins. This is the pure-Python reader and writer;
the native library (`io/native.py`) gives the same `Alignments`.
`write_bam` can also write a samtools-compatible `.bai` index.

BGZF framing: gzip members with a BC extra subfield giving the
compressed block size; EOF = fixed 28-byte empty block.
"""

from __future__ import annotations

import dataclasses
import struct
import zlib

import numpy as np

from .fastq import _fnv1a_batch, normalize_name

_BGZF_EOF = bytes.fromhex(
    "1f8b08040000000000ff0600424302001b0003000000000000000000")

# CIGAR op codes: MIDNSHP=X
_CIGAR_OPS = b"MIDNSHP=X"


@dataclasses.dataclass
class Alignments:
    """Columnar BAM records (one row per alignment line)."""
    tid: np.ndarray        # int32 (-1 unmapped)
    pos: np.ndarray        # int32 0-based
    flag: np.ndarray       # int32
    mapq: np.ndarray       # int32
    mtid: np.ndarray       # int32
    mpos: np.ndarray       # int32 0-based
    tlen: np.ndarray       # int32
    lclip: np.ndarray      # int32 leading S/H length
    rclip: np.ndarray      # int32 trailing S/H length
    nmatch: np.ndarray     # int32 sum of M/=/X lengths
    read_len: np.ndarray   # int32 l_seq
    name_hash: np.ndarray  # uint64
    refs: list[str]        # tid -> reference name
    names: list[bytes] | None = None  # optional (tests/debug)
    # optional full CIGAR retention (keep_cigars=True): flat ragged ops
    # for exact per-base pileup (Coverage.cpp:14-141 semantics)
    cig_op: np.ndarray | None = None   # int8 [total_ops] (MIDNSHP=X idx)
    cig_ln: np.ndarray | None = None   # int32 [total_ops]
    cig_off: np.ndarray | None = None  # int32 [n+1] record offsets

    @property
    def n(self) -> int:
        return len(self.flag)


def _bgzf_decompress(data: bytes) -> bytes:
    out = []
    off = 0
    n = len(data)
    while off < n:
        if data[off:off + 2] != b"\x1f\x8b":
            raise ValueError(f"bad BGZF magic at {off}")
        xlen = struct.unpack_from("<H", data, off + 10)[0]
        extra = data[off + 12: off + 12 + xlen]
        bsize = None
        eoff = 0
        while eoff < len(extra):
            si1, si2, slen = extra[eoff], extra[eoff + 1], \
                struct.unpack_from("<H", extra, eoff + 2)[0]
            if si1 == 0x42 and si2 == 0x43:
                bsize = struct.unpack_from("<H", extra, eoff + 4)[0] + 1
            eoff += 4 + slen
        if bsize is None:
            raise ValueError("BGZF block without BC subfield")
        cdata = data[off + 12 + xlen: off + bsize - 8]
        out.append(zlib.decompress(cdata, -15))
        off += bsize
    return b"".join(out)


def _bgzf_compress(payload: bytes) -> bytes:
    out = []
    CHUNK = 0xFF00
    for i in range(0, max(len(payload), 1), CHUNK):
        chunk = payload[i: i + CHUNK]
        co = zlib.compressobj(6, zlib.DEFLATED, -15)
        cdata = co.compress(chunk) + co.flush()
        bsize = len(cdata) + 12 + 6 + 8
        head = (b"\x1f\x8b\x08\x04" + b"\x00" * 6 +
                struct.pack("<H", 6) + b"BC" + struct.pack("<HH", 2, bsize - 1))
        tail = struct.pack("<II", zlib.crc32(chunk), len(chunk))
        out.append(head + cdata + tail)
    out.append(_BGZF_EOF)
    return b"".join(out)


def read_bam(path: str, keep_names: bool = False,
             keep_cigars: bool = False) -> Alignments:
    with open(path, "rb") as fh:
        raw = _bgzf_decompress(fh.read())
    if raw[:4] != b"BAM\x01":
        raise ValueError("not a BAM file")
    l_text = struct.unpack_from("<i", raw, 4)[0]
    off = 8 + l_text
    n_ref = struct.unpack_from("<i", raw, off)[0]
    off += 4
    refs = []
    for _ in range(n_ref):
        l_name = struct.unpack_from("<i", raw, off)[0]
        name = raw[off + 4: off + 4 + l_name - 1].decode()
        refs.append(name)
        off += 4 + l_name + 4

    cols: dict[str, list[int]] = {k: [] for k in
                                  ("tid", "pos", "flag", "mapq", "mtid",
                                   "mpos", "tlen", "lclip", "rclip",
                                   "nmatch", "read_len")}
    names: list[bytes] = []
    cops: list[int] = []
    clns: list[int] = []
    coffs: list[int] = [0]
    n = len(raw)
    while off < n:
        bsz = struct.unpack_from("<i", raw, off)[0]
        rec = raw[off + 4: off + 4 + bsz]
        off += 4 + bsz
        (tid, pos, l_rn, mapq, _bin, n_cig, flag, l_seq, mtid, mpos,
         tlen) = struct.unpack_from("<iiBBHHHiiii", rec, 0)
        name = rec[32: 32 + l_rn - 1]
        cig_off = 32 + l_rn
        lclip = rclip = nmatch = 0
        ops = []
        for c in range(n_cig):
            v = struct.unpack_from("<I", rec, cig_off + 4 * c)[0]
            ops.append((v >> 4, v & 0xF))
        for ln, op in ops:
            if op in (0, 7, 8):
                nmatch += ln
        # single-op 'S' counts as clipped on BOTH sides, matching the
        # reference's is_clipped (collect_reads_for_gaps.py:13-26)
        if ops and ops[0][1] in (4, 5):
            lclip = ops[0][0]
        if ops and ops[-1][1] in (4, 5):
            rclip = ops[-1][0]
        cols["tid"].append(tid)
        cols["pos"].append(pos)
        cols["flag"].append(flag)
        cols["mapq"].append(mapq)
        cols["mtid"].append(mtid)
        cols["mpos"].append(mpos)
        cols["tlen"].append(tlen)
        cols["lclip"].append(lclip)
        cols["rclip"].append(rclip)
        cols["nmatch"].append(nmatch)
        cols["read_len"].append(l_seq)
        names.append(normalize_name(name))
        if keep_cigars:
            for ln, op in ops:
                cops.append(op)
                clns.append(ln)
            coffs.append(len(cops))

    arr = {k: np.asarray(v, np.int32) for k, v in cols.items()}
    return Alignments(**arr, name_hash=_fnv1a_batch(names), refs=refs,
                      names=names if keep_names else None,
                      cig_op=np.asarray(cops, np.int8) if keep_cigars else None,
                      cig_ln=np.asarray(clns, np.int32) if keep_cigars else None,
                      cig_off=np.asarray(coffs, np.int32) if keep_cigars else None)


_BGZF_CHUNK = 0xFF00


def _reg2bin(beg: int, end: int) -> int:
    """SAM-spec UCSC binning: smallest bin containing [beg, end)."""
    end -= 1
    if beg >> 14 == end >> 14:
        return ((1 << 15) - 1) // 7 + (beg >> 14)
    if beg >> 17 == end >> 17:
        return ((1 << 12) - 1) // 7 + (beg >> 17)
    if beg >> 20 == end >> 20:
        return ((1 << 9) - 1) // 7 + (beg >> 20)
    if beg >> 23 == end >> 23:
        return ((1 << 6) - 1) // 7 + (beg >> 23)
    if beg >> 26 == end >> 26:
        return ((1 << 3) - 1) // 7 + (beg >> 26)
    return 0


def _build_bai(n_ref: int, spans, block_coffsets: list[int]) -> bytes:
    """Build a samtools-compatible .bai index (the reference pipeline
    shells out `samtools index` after every sort, MergeContigs.py:40-44;
    TERefiner auto-creates one via BamTools, bam_parse.cpp:72-96).

    spans: iterable of (tid, beg, end, u_start, u_end) per mapped
    record in file order (coordinate-sorted within each tid), with
    u_start/u_end the record's uncompressed BAM-payload byte offsets
    (including the block_size prefix).  block_coffsets[i] is the
    compressed file offset of the i-th fixed-size BGZF block.
    """
    def vo(u: int) -> int:
        blk, within = u // _BGZF_CHUNK, u % _BGZF_CHUNK
        blk = min(blk, len(block_coffsets) - 1)
        return (block_coffsets[blk] << 16) | within

    per_ref_bins: list[dict[int, list[tuple[int, int]]]] = \
        [dict() for _ in range(n_ref)]
    per_ref_intv: list[dict[int, int]] = [dict() for _ in range(n_ref)]
    for tid, beg, end, u0, u1 in spans:
        if tid < 0 or tid >= n_ref:
            continue
        end = max(end, beg + 1)
        per_ref_bins[tid].setdefault(_reg2bin(beg, end), []).append(
            (vo(u0), vo(u1)))
        for w in range(beg >> 14, ((end - 1) >> 14) + 1):
            cur = per_ref_intv[tid].get(w)
            if cur is None or vo(u0) < cur:
                per_ref_intv[tid][w] = vo(u0)

    out = bytearray(b"BAI\x01" + struct.pack("<i", n_ref))
    for bins, intv in zip(per_ref_bins, per_ref_intv):
        out += struct.pack("<i", len(bins))
        for b in sorted(bins):
            chunks = bins[b]
            out += struct.pack("<Ii", b, len(chunks))
            for v0, v1 in chunks:
                out += struct.pack("<QQ", v0, v1)
        n_intv = (max(intv) + 1) if intv else 0
        out += struct.pack("<i", n_intv)
        last = 0
        for w in range(n_intv):
            last = intv.get(w, last)
            out += struct.pack("<Q", last)
    return bytes(out)


def write_bam(path: str, refs: list[tuple[str, int]], records,
              index: bool = False) -> None:
    """Minimal BAM writer (tests / interchange).

    records: iterable of dicts with keys name, flag, tid, pos, mapq,
    cigar (list[(op_char, len)]), mtid, mpos, tlen, seq(optional str),
    qual(optional phred+33 bytes, 0xFF-filled when absent).

    index=True also writes a samtools-compatible `path + ".bai"`
    (records must then be coordinate-sorted within each tid, tids
    ascending — the usual sorted-BAM contract).
    """
    header_text = "".join(f"@SQ\tSN:{n}\tLN:{l}\n" for n, l in refs)
    body = [b"BAM\x01", struct.pack("<i", len(header_text)),
            header_text.encode(), struct.pack("<i", len(refs))]
    for name, ln in refs:
        nb = name.encode() + b"\x00"
        body += [struct.pack("<i", len(nb)), nb, struct.pack("<i", ln)]
    u_off = sum(len(b) for b in body)
    spans = []
    for r in records:
        name = r["name"].encode() + b"\x00"
        cigar = r.get("cigar", [])
        seq = r.get("seq", "")
        l_seq = len(seq)
        enc_seq = b""
        if seq:
            nib = "=ACMGRSVTWYHKDBN"
            vals = [nib.index(c) if c in nib else 15 for c in seq.upper()]
            if len(vals) % 2:
                vals.append(0)
            enc_seq = bytes((vals[i] << 4) | vals[i + 1]
                            for i in range(0, len(vals), 2))
        q = r.get("qual")
        if q is not None and len(q) >= l_seq:
            # BAM stores raw phred (no +33 offset)
            qual = bytes((b - 33) & 0xFF for b in q[:l_seq])
        else:
            qual = b"\xff" * l_seq
        rec = struct.pack(
            "<iiBBHHHiiii", r["tid"], r["pos"], len(name), r.get("mapq", 60),
            0, len(cigar), r["flag"], l_seq, r.get("mtid", -1),
            r.get("mpos", -1), r.get("tlen", 0))
        rec += name
        for op, oln in cigar:
            rec += struct.pack("<I", (oln << 4) | _CIGAR_OPS.index(
                op.encode() if isinstance(op, str) else op))
        rec += enc_seq + qual
        body += [struct.pack("<i", len(rec)), rec]
        if index and not (r["flag"] & 4) and r["tid"] >= 0:
            ref_span = sum(oln for op, oln in cigar
                           if (op if isinstance(op, str)
                               else op.decode()) in "MDN=X")
            spans.append((r["tid"], r["pos"], r["pos"] + ref_span,
                          u_off, u_off + 4 + len(rec)))
        u_off += 4 + len(rec)
    payload = b"".join(body)
    compressed = _bgzf_compress(payload)
    with open(path, "wb") as fh:
        fh.write(compressed)
    if index:
        # compressed offset of each fixed-size block: re-walk the BGZF
        # framing (each block's BSIZE field gives its compressed size)
        coffs, off = [], 0
        while off < len(compressed) - len(_BGZF_EOF):
            coffs.append(off)
            xlen = struct.unpack_from("<H", compressed, off + 10)[0]
            bsize = None
            extra = compressed[off + 12: off + 12 + xlen]
            eoff = 0
            while eoff < len(extra):
                si1, si2, slen = extra[eoff], extra[eoff + 1], \
                    struct.unpack_from("<H", extra, eoff + 2)[0]
                if si1 == 0x42 and si2 == 0x43:
                    bsize = struct.unpack_from("<H", extra, eoff + 4)[0] + 1
                eoff += 4 + slen
            off += bsize
        # the EOF block's offset terminates the table: when the payload
        # length is an exact multiple of the block size, the final
        # record's chunk-END virtual offset is (payload_len, 0), which
        # must map to the start of the EOF block — clamping it into the
        # last DATA block would invert the chunk and make index-based
        # readers skip that block's records
        coffs.append(len(compressed) - len(_BGZF_EOF))
        with open(path + ".bai", "wb") as fh:
            fh.write(_build_bai(len(refs), spans, coffs or [0]))


def write_bam_columns(path: str, refs: list[tuple[str, int]], *, names,
                      flag, tid, pos, mapq, mtid, mpos, tlen, lclip,
                      rclip, seq, lens, qual=None) -> None:
    """Columnar BAM writer (the production path): native C++ with
    parallel BGZF deflate when available, Python fallback otherwise.

    CIGAR is synthesized as [lclip S][mid M][rclip S] for mapped
    records — the inverse of the collapsed columns `read_bam` produces.
    seq: int8 codes [n, Lmax]; qual: phred+33 bytes or None.
    """
    from . import native
    from .. import dna
    if native.write_bam_columns_native(
            path, refs, names=names, flag=flag, tid=tid, pos=pos,
            mapq=mapq, mtid=mtid, mpos=mpos, tlen=tlen, lclip=lclip,
            rclip=rclip, seq=seq, lens=lens, qual=qual):
        return
    recs = []
    for i in range(len(flag)):
        cigar = []
        if not (int(flag[i]) & 4) and int(lens[i]) > 0:
            if int(lclip[i]) > 0:
                cigar.append(("S", int(lclip[i])))
            mid = int(lens[i]) - int(lclip[i]) - int(rclip[i])
            if mid > 0:
                cigar.append(("M", mid))
            if int(rclip[i]) > 0:
                cigar.append(("S", int(rclip[i])))
        nm = names[i]
        recs.append(dict(
            name=nm.decode() if isinstance(nm, bytes) else nm,
            flag=int(flag[i]), tid=int(tid[i]), pos=int(pos[i]),
            mapq=int(mapq[i]), cigar=cigar, mtid=int(mtid[i]),
            mpos=int(mpos[i]), tlen=int(tlen[i]),
            seq=dna.decode(np.asarray(seq[i][:int(lens[i])])),
            qual=bytes(qual[i][:int(lens[i])]) if qual is not None
            else None))
    write_bam(path, refs, recs)
