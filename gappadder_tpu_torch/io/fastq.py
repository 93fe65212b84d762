"""FASTQ reading into columnar arrays, with 64-bit name hashes
(counterpart of gappadder_tpu/io/fastq.py).

A FASTQ library is a columnar store: int8 sequence codes, lengths,
qualities, and an FNV-1a 64-bit hash per read name. `ReadSet` holds the
payloads; `LazyReadSet` holds only the hashes and byte offsets and
reads a record's payload from the file when it is asked for. The
readers, the scan and the writer take the native library
(`io/native.py`) when it loads, else the pure-Python passes here, which
give the same arrays and bytes.

Read names are normalized like the reference: the token before the
first whitespace, with a trailing "/1" / "/2" stripped.
"""

from __future__ import annotations

import dataclasses
import os

import numpy as np

from .. import dna

_FNV_OFFSET = 0xCBF29CE484222325
_FNV_PRIME = 0x100000001B3
_MASK64 = 0xFFFFFFFFFFFFFFFF


def fnv1a(name: bytes) -> int:
    """FNV-1a 64-bit hash of a byte string."""
    h = _FNV_OFFSET
    for b in name:
        h = ((h ^ b) * _FNV_PRIME) & _MASK64
    return h


def _fnv1a_batch(names: list[bytes]) -> np.ndarray:
    """FNV-1a 64-bit hashes of a list of names, as uint64."""
    out = np.empty(len(names), np.uint64)
    for i, nm in enumerate(names):
        out[i] = fnv1a(nm)
    return out


def normalize_name(raw: bytes) -> bytes:
    """'@NAME/1 comment' -> b'NAME' (the reference's name matching)."""
    if raw.startswith(b"@"):
        raw = raw[1:]
    tok = raw.split()[0] if raw.split() else b""
    slash = tok.rfind(b"/")
    if slash != -1 and tok[slash + 1:] in (b"1", b"2"):
        tok = tok[:slash]
    return tok


@dataclasses.dataclass
class ReadSet:
    """Columnar read store for one FASTQ file."""
    seq: np.ndarray          # int8 [N, Lmax], N-padded
    length: np.ndarray       # int32 [N]
    qual: np.ndarray         # uint8 [N, Lmax] (phred+33 raw bytes)
    name_hash: np.ndarray    # uint64 [N]
    names: list[bytes]       # kept for FASTQ re-emission

    @property
    def n(self) -> int:
        return len(self.length)

    def get_seq(self, row: int) -> np.ndarray:
        return self.seq[row, :self.length[row]]

    def get_qual(self, row: int) -> np.ndarray:
        return self.qual[row, :self.length[row]]

    def get_name(self, row: int) -> bytes:
        return self.names[row]


@dataclasses.dataclass
class LazyReadSet:
    """Offset-indexed FASTQ: name hashes and per-record byte offsets
    only (~38 B a read); payloads are read on demand through mmap."""
    path: str
    name_hash: np.ndarray    # uint64 [N]
    length: np.ndarray       # int32 [N]
    seq_off: np.ndarray      # int64 [N] byte offset of sequence line
    qual_off: np.ndarray     # int64 [N]
    name_off: np.ndarray     # int64 [N] (after '@')
    name_len: np.ndarray     # int32 [N] normalized-name length
    max_len: int

    _mm: object = dataclasses.field(default=None, repr=False, compare=False)

    @property
    def n(self) -> int:
        return len(self.length)

    def _mmap(self):
        if self._mm is None:
            import mmap
            with open(self.path, "rb") as fh:
                self._mm = mmap.mmap(fh.fileno(), 0,
                                     access=mmap.ACCESS_READ)
        return self._mm

    def get_seq(self, row: int) -> np.ndarray:
        mm = self._mmap()
        o = int(self.seq_off[row])
        return dna.encode(mm[o:o + int(self.length[row])])

    def get_qual(self, row: int) -> np.ndarray:
        mm = self._mmap()
        o = int(self.qual_off[row])
        return np.frombuffer(mm[o:o + int(self.length[row])], np.uint8)

    def get_name(self, row: int) -> bytes:
        mm = self._mmap()
        o = int(self.name_off[row])
        return mm[o:o + int(self.name_len[row])]

    def materialize(self, rows) -> ReadSet:
        """Eager ReadSet of just `rows` (payloads read through mmap)."""
        rows = np.asarray(rows, np.int64)
        L = int(self.length[rows].max(initial=1)) if len(rows) else 1
        seq = np.full((len(rows), L), dna.N, np.int8)
        qual = np.zeros((len(rows), L), np.uint8)
        length = np.zeros(len(rows), np.int32)
        names = []
        for i, r in enumerate(rows):
            s = self.get_seq(int(r))
            seq[i, :len(s)] = s
            q = self.get_qual(int(r))
            qual[i, :len(q)] = q
            length[i] = len(s)
            names.append(self.get_name(int(r)))
        return ReadSet(seq=seq, length=length, qual=qual,
                       name_hash=self.name_hash[rows], names=names)


def scan_fastq(path: str | os.PathLike) -> LazyReadSet:
    """Index a FASTQ without holding payloads (the native scan when the
    library loads, else one pure-Python pass)."""
    from . import native
    res = native.scan_fastq_native(str(path))
    if res is not None:
        return LazyReadSet(path=str(path), **res)
    hashes, lens, seq_off, qual_off, name_off, name_len = \
        [], [], [], [], [], []
    max_len = 1
    with open(path, "rb") as fh:
        off = 0
        while True:
            h = fh.readline()
            if not h:
                break
            noff = off + (1 if h.startswith(b"@") else 0)
            nm = normalize_name(h.rstrip())
            off += len(h)
            s = fh.readline()
            seq_off.append(off)
            sl = len(s.rstrip())
            lens.append(sl)
            max_len = max(max_len, sl)
            off += len(s)
            plus = fh.readline()
            off += len(plus)
            q = fh.readline()
            qual_off.append(off)
            off += len(q)
            hashes.append(fnv1a(nm))
            name_off.append(noff)
            name_len.append(len(nm))
    return LazyReadSet(
        path=str(path),
        name_hash=np.asarray(hashes, np.uint64),
        length=np.asarray(lens, np.int32),
        seq_off=np.asarray(seq_off, np.int64),
        qual_off=np.asarray(qual_off, np.int64),
        name_off=np.asarray(name_off, np.int64),
        name_len=np.asarray(name_len, np.int32),
        max_len=max_len)


def read_fastq(path: str | os.PathLike, max_len: int | None = None) -> ReadSet:
    """A whole FASTQ as a ReadSet (pure Python; `pipeline.collect.
    read_fastq_any` takes the native reader first)."""
    names: list[bytes] = []
    seqs: list[bytes] = []
    quals: list[bytes] = []
    with open(path, "rb") as fh:
        while True:
            h = fh.readline()
            if not h:
                break
            s = fh.readline().rstrip()
            fh.readline()  # '+'
            q = fh.readline().rstrip()
            names.append(normalize_name(h.rstrip()))
            seqs.append(s)
            quals.append(q)
    n = len(names)
    L = max_len or (max((len(s) for s in seqs), default=0) or 1)
    seq = np.full((n, L), dna.N, np.int8)
    qual = np.zeros((n, L), np.uint8)
    length = np.zeros(n, np.int32)
    for i, (s, q) in enumerate(zip(seqs, quals)):
        m = min(len(s), L)
        seq[i, :m] = dna.encode(s[:m])
        qual[i, :m] = np.frombuffer(q[:m].ljust(m, b"5"), np.uint8)
        length[i] = m
    return ReadSet(seq=seq, length=length, qual=qual,
                   name_hash=_fnv1a_batch(names), names=names)


def subset(readset: ReadSet, rows) -> ReadSet:
    """Row-select a ReadSet."""
    rows = np.asarray(rows, np.int64)
    return ReadSet(seq=readset.seq[rows], length=readset.length[rows],
                   qual=readset.qual[rows],
                   name_hash=readset.name_hash[rows],
                   names=[readset.names[int(r)] for r in rows])


def subset_by_names(readset: ReadSet, names) -> ReadSet:
    """Subset by read names (bytes or str), in the order asked for."""
    want = [n.encode() if isinstance(n, str) else n for n in names]
    index = {}
    for i, n in enumerate(readset.names):
        index.setdefault(n, i)
    rows = [index[n] for n in want if n in index]
    return subset(readset, rows)


def write_fastq(path_or_fh, readset, rows, suffix: str = "") -> None:
    """Write selected rows as FASTQ, each name with `suffix` appended
    (the reference renames reads to '<id>_1' / '<id>_2'). A path and a
    ReadSet take the native writer when it loads."""
    own = isinstance(path_or_fh, (str, os.PathLike))
    if own and not isinstance(readset, LazyReadSet):
        from . import native
        if native.write_fastq_native(str(path_or_fh), readset, rows, suffix):
            return
    fh = open(path_or_fh, "w") if own else path_or_fh
    try:
        for r in rows:
            r = int(r)
            ln = int(readset.length[r])
            name = readset.get_name(r).decode("ascii") + suffix
            s = dna.decode(readset.get_seq(r)[:ln])
            q = readset.get_qual(r)[:ln].tobytes().decode("ascii")
            fh.write(f"@{name}\n{s}\n+\n{q}\n")
    finally:
        if own:
            fh.close()
