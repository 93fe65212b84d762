"""FASTA reading and writing into columnar arrays (counterpart of
gappadder_tpu/io/fasta.py, copied: the port imports nothing of the JAX
package).

The genome is stored as ONE concatenated int8 code array with a SEP
sentinel between scaffolds (so N-run detection can never bridge two
scaffolds) plus an offsets table. The writers give the JAX package's
bytes: 80-column lines, an empty record as one empty line; `write_fai`
writes a samtools-compatible `.fai` index.
"""

from __future__ import annotations

import dataclasses
import io
import os

import numpy as np

from .. import dna


@dataclasses.dataclass
class Genome:
    """Concatenated scaffolds. ``seq[offsets[i]:offsets[i]+lengths[i]]``
    is scaffold i; one SEP code sits between consecutive scaffolds."""

    seq: np.ndarray        # int8 codes, len = sum(lengths) + (S-1)
    offsets: np.ndarray    # int64 [S] start of each scaffold in seq
    lengths: np.ndarray    # int64 [S]
    names: list[str]

    @property
    def num_scaffolds(self) -> int:
        return len(self.names)

    def scaffold(self, i: int) -> np.ndarray:
        return self.seq[self.offsets[i]: self.offsets[i] + self.lengths[i]]

    def scaffold_index(self, positions: np.ndarray) -> np.ndarray:
        """Map global positions in ``seq`` to scaffold indices."""
        return np.searchsorted(self.offsets, np.asarray(positions), side="right") - 1

    def to_local(self, positions: np.ndarray) -> np.ndarray:
        """Convert global positions to per-scaffold coordinates."""
        return np.asarray(positions) - self.offsets[self.scaffold_index(positions)]


# Drafts past this size route through the chunked vectorized parser
# (the per-line Python loop below costs ~1 min/GB; the vectorized path
# is ~20x faster and holds only one chunk of raw text at a time).
_BIG_FASTA_BYTES = 32 << 20


def read_fasta(path: str | os.PathLike) -> Genome:
    try:
        if os.path.getsize(path) >= _BIG_FASTA_BYTES:
            return read_fasta_chunked(path)
    except OSError:
        pass
    names: list[str] = []
    chunks: list[bytes] = []
    cur: list[bytes] = []
    with open(path, "rb") as fh:
        for line in fh:
            line = line.rstrip()
            if not line:
                continue
            if line.startswith(b">"):
                if names:
                    chunks.append(b"".join(cur))
                    cur = []
                names.append(line[1:].split()[0].decode("ascii"))
            else:
                cur.append(line)
    if names:
        chunks.append(b"".join(cur))
    if not names:
        return Genome(np.zeros(0, np.int8), np.zeros(0, np.int64),
                      np.zeros(0, np.int64), [])

    lengths = np.array([len(c) for c in chunks], dtype=np.int64)
    offsets = np.zeros(len(chunks), dtype=np.int64)
    np.cumsum(lengths[:-1] + 1, out=offsets[1:])  # +1 for SEP between
    total = int(offsets[-1] + lengths[-1])
    seq = np.full(total, dna.SEP, dtype=np.int8)
    for off, chunk in zip(offsets, chunks):
        seq[off: off + len(chunk)] = dna.encode(chunk)
    return Genome(seq=seq, offsets=offsets, lengths=lengths, names=names)


def read_fasta_chunked(path: str | os.PathLike,
                       chunk_bytes: int = 64 << 20) -> Genome:
    """Bounded-memory FASTA parser for production-scale drafts (>1 GB):
    text is read in newline-aligned chunks; base extraction is one
    C-level translate per header-delimited region (no per-line Python),
    so peak memory is ~1x genome size + one chunk. Output is identical
    to `read_fasta`.
    """
    names: list[str] = []
    rec_counts: list[np.ndarray] = []   # per-chunk per-record base counts
    rec_bases: list[int] = []           # first record index of each chunk
    enc_parts: list[np.ndarray] = []    # per-chunk encoded bases (in order)

    def process(data: bytes):
        # data always ends with '\n'. Headers start at offset 0 or right
        # after a newline; everything between a header line and the next
        # header is one record's sequence region — EOL bytes are deleted
        # with one C-level translate pass per region (headers are few,
        # so this is ~2 passes over the chunk total).
        hdr_starts = []
        if data.startswith(b">"):
            hdr_starts.append(0)
        p = data.find(b"\n>")
        while p != -1:
            hdr_starts.append(p + 1)
            p = data.find(b"\n>", p + 1)
        rec0 = len(names) - 1   # record continuing from the last chunk
        regions = [(0, hdr_starts[0] if hdr_starts else len(data), rec0)]
        for i, h in enumerate(hdr_starts):
            e = data.find(b"\n", h)
            names.append(data[h + 1:e].split()[0].decode("ascii"))
            nxt = hdr_starts[i + 1] if i + 1 < len(hdr_starts) else len(data)
            regions.append((e + 1, nxt, rec0 + 1 + i))
        for s, e, r in regions:
            if r < 0 or s >= e:     # pre-header junk / empty record
                continue
            seq = data[s:e].translate(None, b"\r\n")
            if seq:
                enc_parts.append(dna.encode(seq))
                rec_bases.append(r)
                rec_counts.append(np.array([len(seq)], np.int64))

    with open(path, "rb") as fh:
        carry = b""
        while True:
            buf = fh.read(chunk_bytes)
            if not buf:
                break
            data = carry + buf
            cut = data.rfind(b"\n")
            if cut < 0:
                carry = data
                continue
            carry = data[cut + 1:]
            process(data[:cut + 1])
        if carry:
            process(carry + b"\n")

    if not names:
        return Genome(np.zeros(0, np.int8), np.zeros(0, np.int64),
                      np.zeros(0, np.int64), [])
    lengths = np.zeros(len(names), np.int64)
    for base, counts in zip(rec_bases, rec_counts):
        lengths[base:base + len(counts)] += counts
    offsets = np.zeros(len(names), dtype=np.int64)
    np.cumsum(lengths[:-1] + 1, out=offsets[1:])
    total = int(offsets[-1] + lengths[-1]) if len(names) else 0
    seq = np.full(total, dna.SEP, dtype=np.int8)
    filled = np.zeros(len(names), np.int64)
    for base, counts, enc in zip(rec_bases, rec_counts, enc_parts):
        pos = 0
        for j, c in enumerate(counts):      # few records per chunk
            c = int(c)
            if c == 0:
                continue
            r = base + j
            dst = int(offsets[r] + filled[r])
            seq[dst:dst + c] = enc[pos:pos + c]
            filled[r] += c
            pos += c
    return Genome(seq=seq, offsets=offsets, lengths=lengths, names=names)


def iter_fasta(path: str | os.PathLike):
    """Yield (name, int8 codes) per record without concatenation."""
    g = read_fasta(path)
    for i, name in enumerate(g.names):
        yield name, g.scaffold(i)


def write_fasta(path_or_fh, records, width: int = 80) -> None:
    """Write (name, codes-or-str) records as FASTA."""
    own = isinstance(path_or_fh, (str, os.PathLike))
    fh = open(path_or_fh, "w") if own else path_or_fh
    try:
        for name, seq in records:
            if not isinstance(seq, str):
                seq = dna.decode(seq)
            fh.write(f">{name}\n")
            for i in range(0, len(seq), width):
                fh.write(seq[i: i + width] + "\n")
            if len(seq) == 0:
                fh.write("\n")
    finally:
        if own:
            fh.close()


def fasta_string(records, width: int = 80) -> str:
    buf = io.StringIO()
    write_fasta(buf, records, width)
    return buf.getvalue()


def write_fai(fasta_path: str | os.PathLike,
              out_path: str | os.PathLike | None = None) -> str:
    """Write a samtools-compatible .fai index for a FASTA file (the
    reference shells out `samtools faidx`, main.py:208-210).

    Columns: name, length, byte offset of first base, bases per line,
    bytes per line (incl. newline)."""
    out_path = str(out_path or (str(fasta_path) + ".fai"))
    rows = []
    with open(fasta_path, "rb") as fh:
        name = None
        length = 0
        offset = 0
        linebases = 0
        linewidth = 0
        first_line = True
        pos = 0
        for line in fh:
            ll = len(line)
            stripped = line.rstrip(b"\r\n")
            if stripped.startswith(b">"):
                if name is not None:
                    rows.append((name, length, offset, linebases, linewidth))
                name = stripped[1:].split()[0].decode()
                length = 0
                offset = pos + ll
                first_line = True
            elif stripped:
                if first_line:
                    linebases = len(stripped)
                    linewidth = ll
                    first_line = False
                length += len(stripped)
            pos += ll
        if name is not None:
            rows.append((name, length, offset, linebases, linewidth))
    with open(out_path, "w") as fh:
        for r in rows:
            fh.write("\t".join(str(x) for x in r) + "\n")
    return out_path


def fasta_string(records, width: int = 80) -> str:
    buf = io.StringIO()
    write_fasta(buf, records, width)
    return buf.getvalue()
