"""The traffic generators: seed 0 of the frozen `genome_files.write_scenario`
writes the draft, FASTQs and BAM records of the port's
`testcases.collect_scenario` (this test imports the port; the harness's
run path does not), and `gap_batches.batch` gives a mapper's records of
a paired library around the gaps, the same for one seed."""

import numpy as np
import pytest

from portbench.traffic import gap_batches, genome_files

SMALL = dict(n_scaffolds=2, scaffold_len=60_000, gaps_per_scaffold=4,
             gap_len=(100, 400),
             libraries=((300, 50, 100, 30.0), (10_000, 500, 100, 5.0)),
             n_open=1, mapq0=0.02, chimeric=0.01)
KSET = ((30, 29), (30, 27), (40, 39), (40, 37), (50, 49), (50, 47))
BAM_COLUMNS = ("tid", "pos", "flag", "mapq", "mtid", "mpos", "tlen", "lclip",
               "rclip", "nmatch", "read_len", "name_hash")


@pytest.mark.parametrize("seed", [0, 5])
def test_genome_files_equal_the_ports_collect_scenario(tmp_path, seed):
    from gappadder_tpu_torch import testcases
    from gappadder_tpu_torch.io import bam
    sc = genome_files.write_scenario(tmp_path / "a", seed, **SMALL)
    _cfg, truth = testcases.collect_scenario(tmp_path / "b", seed, **SMALL)
    for name in ("draft.fa", "lib0_1.fastq", "lib0_2.fastq", "lib1_1.fastq",
                 "lib1_2.fastq"):
        assert (tmp_path / "a" / name).read_bytes() == \
            (tmp_path / "b" / name).read_bytes(), name
    for li in range(2):
        a = bam.read_bam(str(tmp_path / "a" / f"lib{li}.bam"),
                         keep_names=True, keep_cigars=True)
        b = bam.read_bam(str(tmp_path / "b" / f"lib{li}.bam"),
                         keep_names=True, keep_cigars=True)
        assert a.refs == b.refs and a.names == b.names
        for k in BAM_COLUMNS + ("cig_op", "cig_ln", "cig_off"):
            assert np.array_equal(getattr(a, k), getattr(b, k)), (li, k)
        rec = sc["libraries"][li]["records"]
        assert np.array_equal(rec["flag"], b.flag)
        assert np.array_equal(rec["pos"], b.pos)
    assert np.array_equal(sc["gaps"], truth["gaps"])
    assert sc["open"] == truth["open"]
    assert [lib["pairs"] for lib in sc["libraries"]] == truth["pairs"]
    assert all(np.array_equal(x, y) for x, y in zip(sc["scaffolds"],
                                                  truth["scaffolds"]))


def test_genome_files_records_name_their_fastq_rows(tmp_path):
    """Each BAM record's pair and mate give the FASTQ read it holds."""
    from gappadder_tpu_torch.io import bam
    sc = genome_files.write_scenario(tmp_path, 3, **SMALL)
    lib = sc["libraries"][0]
    aln = bam.read_bam(lib["bam"], keep_names=True)
    rec = lib["records"]
    names = [lib["names"][p].tobytes() for p in rec["pair"]]
    assert names == aln.names
    mate = (~rec["first"]).astype(int)
    assert np.array_equal(rec["flag"] & 0x40 != 0, rec["first"])
    assert lib["seq"][mate, rec["pair"]].shape == (len(names), 100)


def gap_batch(seed, **kw):
    from portbench.harness import bench
    _b, _e, _w, cfg = bench.load_cell("chr14.step")
    b, lib = dict(cfg["batch"], gaps=8, **kw), cfg["library"]
    return gap_batches.batch(
        seed, **{k: b[k] for k in ("gaps", "gap_len", "read_len",
                                    "coverage", "errors", "mapq",
                                    "chimeric", "foreign_len")},
        flank_len=300, insert=lib["is"], std=lib["std"], dist2=450,
        caps=cfg["caps"], kset=KSET)


def test_gap_batches_follow_the_seed_and_keep_one_shape():
    d0, a0 = gap_batch(5)
    d1, a1 = gap_batch(5)
    d2, a2 = gap_batch(6)
    assert d0 == d1 == d2
    assert all(np.array_equal(x, y) for x, y in zip(a0, a1))
    assert not np.array_equal(a0[22], a2[22])


def test_gap_batches_are_a_mappers_records():
    _d, a = gap_batch(7, chimeric=0.05)
    tid, pos, flag, mapq, mtid, mpos, tlen, lclip, rclip = (
        np.asarray(x, np.int64) for x in a[:9])
    gs, ge = np.asarray(a[16], np.int64), np.asarray(a[17], np.int64)
    unmapped = (flag & 4) != 0
    # an unmapped read sits at its mate's place; a pair inside a gap is
    # flagged 12 and unplaced
    half = unmapped & ((flag & 8) == 0)
    assert half.any() and np.array_equal(pos[half], mpos[half])
    both = (flag & 12) == 12
    assert both.any() and (tid[both] == -1).all()
    # clipped reads keep 20 aligned bases beside a gap, on the gap side
    clip = ~unmapped & ((lclip > 0) | (rclip > 0))
    assert clip.any() and (100 - lclip[clip] - rclip[clip] >= 20).all()
    assert np.isin(pos[~unmapped & (lclip > 0)], ge).all()
    # no mapped read lies inside a gap
    j = np.searchsorted(ge, pos[~unmapped & (tid == 0)], side="right")
    inside = (j < len(gs)) & (pos[~unmapped & (tid == 0)] >= gs[
        np.minimum(j, len(gs) - 1)])
    assert not inside.any()
    # chimeric pairs: a mapped read whose mate is on the other scaffold
    cross = ~unmapped & ((flag & 8) == 0) & (mtid != tid)
    assert cross.any() and (tlen[cross] == 0).all()
    # the mapq mix, and mapq 0 on unmapped reads
    mq = mapq[~unmapped]
    for lo, hi, share in ((0, 0, 0.02), (1, 29, 0.03), (30, 59, 0.05)):
        got = ((mq >= lo) & (mq <= hi)).mean()
        assert abs(got - share) < 0.4 * share, (lo, got)
    assert (mapq[unmapped] == 0).all()
    # both mates of every pair in the read table, read 1 and read 2
    assert len(a[22]) == 2 * len(np.unique(np.asarray(a[10])))
    assert sorted(set(np.asarray(a[21]).tolist())) == [0, 1]


def test_gap_batch_reads_carry_their_error_rate():
    """Error-free pairs span their fragment's truth; at 5 % a read
    differs from its error-free self in about 5 of 100 bases."""
    _d, clean = gap_batch(3, errors=0.0)
    _d, noisy = gap_batch(3, errors=0.05)
    diff = (np.asarray(clean[22]) != np.asarray(noisy[22])).mean()
    assert 0.04 < diff < 0.06
