"""The port's BAM and FASTQ I/O (`gappadder_tpu_torch.io.bam`, `.fastq`,
`.native`) against the JAX package's, on the cases of
tests/test_native_io.py and tests/test_bam_edge_cases.py. Every case
runs twice: with the native library, and with it made unavailable so
that the pure-Python readers and writers run. Columns, hashes and file
bytes must be equal."""

import struct

import numpy as np
import pytest

from gappadder_tpu.io import bam as jbam
from gappadder_tpu.io import fastq as jfastq
from gappadder_tpu.pipeline import collect as jcollect
from gappadder_tpu_torch.io import bam as tbam
from gappadder_tpu_torch.io import fastq as tfastq
from gappadder_tpu_torch.io import native as tnative
from gappadder_tpu_torch.pipeline import collect as tcollect

COLS = ("tid", "pos", "flag", "mapq", "mtid", "mpos", "tlen", "lclip",
        "rclip", "nmatch", "read_len", "name_hash")


@pytest.fixture(params=["native", "python"])
def io_path(request, monkeypatch):
    """Which of the port's paths runs: the native library, or none."""
    if request.param == "native":
        if not tnative.available():
            pytest.skip("the native library neither loads nor builds here")
    else:
        monkeypatch.setattr(tnative, "_load", lambda: None)
        assert not tnative.available() and tnative.source() is None
    return request.param


def same_alignments(a, b):
    assert a.refs == b.refs
    assert a.n == b.n
    for k in COLS:
        x, y = getattr(a, k), getattr(b, k)
        assert x.dtype == y.dtype, k
        np.testing.assert_array_equal(x, y, err_msg=k)


def _random_records(rng, n=50):
    recs = []
    for i in range(n):
        cig = []
        if rng.integers(0, 2):
            cig.append(("S", int(rng.integers(1, 30))))
        cig.append(("M", int(rng.integers(10, 100))))
        if rng.integers(0, 2):
            cig.append(("S", int(rng.integers(1, 30))))
        recs.append(dict(
            name=f"read{i}/1 comment", flag=int(rng.choice([0x41, 0x85, 0x4D])),
            tid=int(rng.integers(0, 3)), pos=int(rng.integers(0, 900)),
            mapq=int(rng.choice([0, 30, 60])), cigar=cig,
            mtid=int(rng.integers(-1, 3)), mpos=int(rng.integers(0, 900)),
            tlen=int(rng.integers(-500, 500)),
            seq="ACGT" * int(rng.integers(5, 20))))
    return recs


def test_bam_readers_and_writer_match_jax(tmp_path, rng, io_path):
    refs = [("c1", 1000), ("c2", 500), ("long_name.scaffold-3", 77)]
    recs = _random_records(rng)
    jpath, tpath = str(tmp_path / "j.bam"), str(tmp_path / "t.bam")
    jbam.write_bam(jpath, refs, recs)
    tbam.write_bam(tpath, refs, recs)
    assert open(jpath, "rb").read() == open(tpath, "rb").read()
    want = jbam.read_bam(jpath, keep_names=True)
    same_alignments(want, tbam.read_bam(jpath))
    same_alignments(want, tcollect.read_bam_any(jpath))
    assert tbam.read_bam(jpath, keep_names=True).names == want.names


CIGAR_ZOO = [
    dict(name="hardclip", flag=0x841, tid=0, pos=1,
         cigar=[("H", 9), ("M", 30), ("H", 2)], mtid=0, mpos=50, tlen=80),
    dict(name="single_s", flag=0x585, tid=0, pos=2, cigar=[("S", 50)],
         mtid=-1, mpos=-1, tlen=0),
    dict(name="eq_x_ops", flag=0, tid=0, pos=3,
         cigar=[("=", 10), ("X", 5), ("=", 10)], mtid=-1, mpos=-1, tlen=0),
    dict(name="with_intron", flag=0, tid=0, pos=4,
         cigar=[("M", 10), ("N", 100), ("M", 10)], mtid=-1, mpos=-1, tlen=0),
    dict(name="indels", flag=0, tid=0, pos=5,
         cigar=[("S", 3), ("M", 10), ("I", 4), ("M", 5), ("D", 2),
                ("M", 8), ("S", 7)], mtid=-1, mpos=-1, tlen=0),
    dict(name="weird/1 with spaces", flag=0, tid=0, pos=3,
         cigar=[("=", 10), ("X", 5)], mtid=-1, mpos=-1, tlen=-1),
    dict(name="unmapped", flag=4, tid=-1, pos=-1, cigar=[], mtid=-1,
         mpos=-1, tlen=0),
]


def test_cigar_zoo_matches_jax(tmp_path, io_path):
    path = str(tmp_path / "edge.bam")
    tbam.write_bam(path, [("c", 10000)], CIGAR_ZOO)
    want = jbam.read_bam(path, keep_names=True, keep_cigars=True)
    got = tbam.read_bam(path, keep_names=True, keep_cigars=True)
    same_alignments(want, got)
    assert got.names == want.names
    for k in ("cig_op", "cig_ln", "cig_off"):
        np.testing.assert_array_equal(getattr(want, k), getattr(got, k))
    same_alignments(want, tcollect.read_bam_any(path))
    by = {n.decode(): i for i, n in enumerate(got.names)}
    assert got.lclip[by["single_s"]] == got.rclip[by["single_s"]] == 50
    assert got.nmatch[by["indels"]] == 23


def test_bai_chunk_end_at_block_boundary_matches_jax():
    chunk = 0xFF00
    spans = [(0, 10, 50, chunk - 64, chunk)]     # u_end on the boundary
    raw = tbam._build_bai(1, spans, [0, 777])
    assert raw == jbam._build_bai(1, spans, [0, 777])
    v0, v1 = struct.unpack_from("<QQ", raw, 20)
    assert v1 == 777 << 16 and v1 > v0


def test_indexed_bam_matches_jax(tmp_path, io_path):
    """2000 coordinate-sorted records over several BGZF blocks: the BAM
    and its .bai are the JAX package's bytes."""
    rng = np.random.default_rng(0)
    recs = [dict(name=f"r{i}", flag=0, tid=0, pos=10 + i * 3, mapq=60,
                 mtid=-1, mpos=-1, tlen=0, cigar=[("M", 100)],
                 seq="".join("ACGT"[b] for b in rng.integers(0, 4, 100)))
            for i in range(2000)]
    paths = [str(tmp_path / f"{w}.bam") for w in ("j", "t")]
    jbam.write_bam(paths[0], [("scaf0", 100000)], recs, index=True)
    tbam.write_bam(paths[1], [("scaf0", 100000)], recs, index=True)
    for suffix in ("", ".bai"):
        assert open(paths[0] + suffix, "rb").read() == \
            open(paths[1] + suffix, "rb").read()
    same_alignments(jbam.read_bam(paths[0]), tcollect.read_bam_any(paths[1]))


def test_stream_path_matches_jax(tmp_path, rng, monkeypatch, io_path):
    """read_bam_any above STREAM_THRESHOLD (patched down to 0): the
    native stream, or the Python reader without the library."""
    refs = [("c1", 5000), ("c2", 900)]
    recs = []
    for i in range(997):
        cig = [("M", int(rng.integers(20, 120)))]
        if rng.integers(0, 2):
            cig = [("S", int(rng.integers(1, 20)))] + cig
        recs.append(dict(
            name=f"sr{i}/1", flag=int(rng.choice([0x41, 0x85])),
            tid=int(rng.integers(0, 2)), pos=int(rng.integers(0, 800)),
            mapq=int(rng.choice([0, 60])), cigar=cig,
            mtid=int(rng.integers(0, 2)), mpos=int(rng.integers(0, 800)),
            tlen=int(rng.integers(-400, 400)),
            seq="ACGT" * int(rng.integers(5, 30))))
    path = str(tmp_path / "s.bam")
    jbam.write_bam(path, refs, recs)
    monkeypatch.setattr(tcollect, "STREAM_THRESHOLD", 0)
    monkeypatch.setattr(jcollect, "STREAM_THRESHOLD", 0)
    same_alignments(jcollect.read_bam_any(path), tcollect.read_bam_any(path))
    if io_path == "native":
        chunks = list(tnative.stream_bam_native(path, chunk_records=100))
        assert len(chunks) == 10 and sum(c.n for c in chunks) == 997
    else:
        assert tnative.stream_bam_native(path) is None


def _columns(rng, n=40, L=60):
    lens = np.full(n, L, np.int32)
    return dict(
        names=[f"q{i}".encode() for i in range(n)],
        flag=rng.choice([0x41, 0x85, 0x4D], n).astype(np.int32),
        tid=np.zeros(n, np.int32), pos=np.arange(n, dtype=np.int32) * 10,
        mapq=np.full(n, 60, np.int32), mtid=np.full(n, -1, np.int32),
        mpos=np.zeros(n, np.int32), tlen=np.zeros(n, np.int32),
        lclip=np.full(n, 5, np.int32), rclip=np.zeros(n, np.int32),
        seq=rng.integers(0, 4, (n, L)).astype(np.int8), lens=lens,
        qual=rng.integers(35, 70, (n, L)).astype(np.uint8))


def test_write_bam_columns_matches_jax(tmp_path, rng, io_path, monkeypatch):
    """The columnar writer (native, or the Python fallback) decodes to
    the JAX writer's columns; the fallback writes the JAX fallback's
    bytes."""
    kw = _columns(rng)
    kw["lclip"][kw["flag"] & 4 != 0] = 0
    refs = [("s", 900)]
    tpath, jpath = str(tmp_path / "t.bam"), str(tmp_path / "j.bam")
    tbam.write_bam_columns(tpath, refs, **kw)
    if io_path == "python":
        from gappadder_tpu.io import native as jnative
        monkeypatch.setattr(jnative, "write_bam_columns_native",
                            lambda *a, **k: False)
    jbam.write_bam_columns(jpath, refs, **kw)
    same_alignments(jbam.read_bam(jpath), tbam.read_bam(tpath))
    if io_path == "python":
        assert open(jpath, "rb").read() == open(tpath, "rb").read()


def test_long_names_match_jax(tmp_path, io_path):
    """QNAMEs over 254 bytes: the native writer clamps them (samtools'
    limit) as the JAX package's does; the Python writer cannot store
    them and raises as the JAX one does."""
    n, L = 3, 20
    kw = dict(names=[b"x" * 300, b"ok_name", b"y" * 254],
              flag=np.zeros(n, np.int32), tid=np.zeros(n, np.int32),
              pos=np.arange(n, dtype=np.int32), mapq=np.full(n, 60, np.int32),
              mtid=np.full(n, -1, np.int32), mpos=np.zeros(n, np.int32),
              tlen=np.zeros(n, np.int32), lclip=np.zeros(n, np.int32),
              rclip=np.zeros(n, np.int32), seq=np.zeros((n, L), np.int8),
              lens=np.full(n, L, np.int32))
    path = str(tmp_path / "long.bam")
    if io_path == "python":
        with pytest.raises(struct.error):
            tbam.write_bam_columns(path, [("s", 500)], **kw)
        from gappadder_tpu.io import native as jnative
        import unittest.mock as mock
        with mock.patch.object(jnative, "write_bam_columns_native",
                               return_value=False), \
                pytest.raises(struct.error):
            jbam.write_bam_columns(path, [("s", 500)], **kw)
        return
    tbam.write_bam_columns(path, [("s", 500)], **kw)
    a = tbam.read_bam(path, keep_names=True)
    assert a.names == [b"x" * 254, b"ok_name", b"y" * 254]
    jpath = str(tmp_path / "jlong.bam")
    jbam.write_bam_columns(jpath, [("s", 500)], **kw)
    assert open(jpath, "rb").read() == open(path, "rb").read()


def _write_fastq_text(path, rng, n=30):
    with open(path, "w") as fh:
        for i in range(n):
            m = int(rng.integers(5, 60))
            s = "".join(np.array(list("ACGTN"))[rng.integers(0, 5, m)])
            q = "".join(chr(c) for c in rng.integers(33, 74, m))
            head = [f"@r{i}/{1 + i % 2} extra words", f"@r{i}", f"@r{i}/1",
                    f"@r{i} x/1"][i % 4]
            fh.write(f"{head}\n{s}\n+\n{q}\n")
        fh.write("@empty_read/2\n\n+\n\n")          # an empty read
        fh.write("@r3/2 a repeated name\nACGT\n+\nIIII\n")


def same_readsets(a, b):
    assert a.names == b.names
    for k in ("name_hash", "length"):
        np.testing.assert_array_equal(getattr(a, k), getattr(b, k))
    L = min(a.seq.shape[1], b.seq.shape[1])
    np.testing.assert_array_equal(a.seq[:, :L], b.seq[:, :L])
    np.testing.assert_array_equal(a.qual[:, :L], b.qual[:, :L])


def test_fastq_readers_match_jax(tmp_path, rng, io_path):
    path = str(tmp_path / "x.fastq")
    _write_fastq_text(path, rng)
    want = jfastq.read_fastq(path)
    same_readsets(want, tfastq.read_fastq(path))
    same_readsets(want, tcollect.read_fastq_any(path))
    assert tfastq._fnv1a_batch(want.names).tolist() == \
        jfastq._fnv1a_batch(want.names).tolist()
    sub = tfastq.subset(tfastq.read_fastq(path), [3, 1, 7])
    same_readsets(jfastq.subset(want, [3, 1, 7]), sub)
    by = tfastq.subset_by_names(tfastq.read_fastq(path),
                                ["r9", "missing", b"r0", "r3"])
    same_readsets(jfastq.subset_by_names(want, ["r9", "missing", b"r0",
                                                "r3"]), by)
    assert by.names == [b"r9", b"r0", b"r3"]


def test_scan_fastq_matches_jax(tmp_path, rng, io_path):
    """The index (hashes and byte offsets) of names with /1 and /2,
    extra header fields, a repeated name and an empty read; and the
    payloads it reads back."""
    path = str(tmp_path / "x.fastq")
    _write_fastq_text(path, rng)
    want = jfastq.scan_fastq(path)
    got = tfastq.scan_fastq(path)
    for k in ("name_hash", "length", "seq_off", "qual_off", "name_off",
              "name_len"):
        x, y = getattr(want, k), getattr(got, k)
        assert x.dtype == y.dtype, k
        np.testing.assert_array_equal(x, y, err_msg=k)
    assert want.max_len == got.max_len and got.n == 32
    assert got.length[-2] == 0
    rows = [31, 0, 30, 5, 5]
    same_readsets(want.materialize(rows), got.materialize(rows))
    for r in (0, 30, 31):
        assert got.get_name(r) == want.get_name(r)


def test_write_fastq_matches_jax(tmp_path, rng, io_path):
    """The FASTQ writer (native, or Python) writes the JAX package's
    bytes, with the suffix renaming, row order and append mode."""
    n, L = 200, 80
    lens = rng.integers(10, L + 1, n).astype(np.int32)
    seq = np.full((n, L), 4, np.int8)
    qual = np.zeros((n, L), np.uint8)
    for i in range(n):
        seq[i, :lens[i]] = rng.integers(0, 4, lens[i])
        qual[i, :lens[i]] = rng.integers(33, 74, lens[i])
    kw = dict(seq=seq, length=lens, qual=qual,
              name_hash=np.zeros(n, np.uint64),
              names=[f"r{i}".encode() for i in range(n)])
    rows = rng.permutation(n)[:77]
    jp, tp = str(tmp_path / "j.fastq"), str(tmp_path / "t.fastq")
    jfastq.write_fastq(jp, jfastq.ReadSet(**kw), rows, suffix="_1")
    tfastq.write_fastq(tp, tfastq.ReadSet(**kw), rows, suffix="_1")
    assert open(jp, "rb").read() == open(tp, "rb").read()
    with open(tp, "a") as fh:
        tfastq.write_fastq(fh, tfastq.ReadSet(**kw), rows[:5], suffix="_2")
    assert tfastq.read_fastq(tp).n == 82
    if io_path == "native":
        assert tnative.write_fastq_native(tp, tfastq.ReadSet(**kw), rows[:3],
                                          suffix="_2", append=True)
        assert tfastq.read_fastq(tp).n == 85
    else:
        assert not tnative.write_fastq_native(tp, tfastq.ReadSet(**kw), rows)


def test_native_library_source():
    """The library taken is the committed one (or the one built from
    native/bamio.cpp into build/), never one written into native/."""
    src = tnative.source()
    assert src in ("native/libbamio.so", "build/libbamio.so", None)
    assert tnative.available() == (src is not None)


def test_native_library_builds_into_build_when_missing(tmp_path, monkeypatch):
    """Without a loadable native/libbamio.so, native/bamio.cpp is compiled
    with g++ into build/libbamio.so (never into native/); the library
    built there reads a BAM as the JAX package's reader does."""
    import shutil
    if shutil.which("g++") is None:
        pytest.skip("no g++ on this machine")
    root = tmp_path / "checkout"
    (root / "native").mkdir(parents=True)
    shutil.copy(tnative.NATIVE_DIR / "bamio.cpp", root / "native")
    for name, value in (("_ROOT", root), ("NATIVE_DIR", root / "native"),
                        ("BUILD", root / "build"), ("_TRIED", False),
                        ("_LIB", None), ("_SOURCE", None)):
        monkeypatch.setattr(tnative, name, value)
    assert tnative.source() == "build/libbamio.so"
    assert sorted(p.name for p in (root / "native").iterdir()) == \
        ["bamio.cpp"]
    path = str(tmp_path / "z.bam")
    jbam.write_bam(path, [("c", 10000)], CIGAR_ZOO)
    same_alignments(jbam.read_bam(path), tnative.read_bam_native(path))
