"""Port parity of tools/refiner.py, tools/scaffold.py and ops/coverage.py
against the JAX package's modules: tests/test_tools.py's refiner,
scaffold and coverage cases, and every TERefiner mode over one BAM of
contigs with varied CIGARs, names and flags, each with exact equality.
The port runs on the CPU, where its SW calls take the kernel's plain
version."""

import numpy as np
import pytest

from gappadder_tpu import dna as jdna
from gappadder_tpu.io import bam as jbam
from gappadder_tpu.ops import coverage as jcov
from gappadder_tpu.tools import refiner as jref
from gappadder_tpu.tools import scaffold as jscaf
from gappadder_tpu_torch.io import bam as tbam
from gappadder_tpu_torch.ops import coverage as tcov
from gappadder_tpu_torch.tools import refiner as tref
from gappadder_tpu_torch.tools import scaffold as tscaf

from test_torch_run_scenarios import one_torch_thread  # noqa: F401


def plain(x):
    """Nested results as plain Python values (arrays as dtype + list)."""
    if isinstance(x, dict):
        return {k: plain(v) for k, v in x.items()}
    if isinstance(x, (tuple, list)):
        return [plain(v) for v in x]
    if isinstance(x, set):
        return sorted(x)
    if isinstance(x, np.ndarray):
        return (x.dtype.str, x.tolist())
    if isinstance(x, np.generic):
        return x.item()
    return x


class FakeAln:
    def __init__(self, **kw):
        for k, v in kw.items():
            setattr(self, k, np.asarray(v))


def _cov_aln():
    return FakeAln(tid=[0, 0, 0, 1, 0], nmatch=[50, 50, 100, 25, 10],
                   read_len=[50, 50, 100, 25, 100],
                   pos=[0, 50, 0, 0, 0], flag=[0] * 5, mapq=[60] * 5,
                   mtid=[-1] * 5, mpos=[0] * 5, tlen=[0] * 5,
                   lclip=[0] * 5, rclip=[0] * 5)


def _link_aln():
    flags_base = 0x1 | 0x40
    return FakeAln(
        tid=[0, 0, 0, 0, 1], mtid=[1, 1, 1, 1, 0],
        pos=[250, 250, 250, 100, 10], mpos=[20, 20, 20, 20, 250],
        mapq=[60] * 5,
        flag=[flags_base | 0x20, flags_base | 0x20, flags_base | 0x10,
              flags_base | 0x20, 0x1 | 0x80],
        nmatch=[100] * 5, read_len=[100] * 5,
        lclip=[0] * 5, rclip=[0] * 5, tlen=[0] * 5)


# (name, call(refiner, coverage module)) over the columnar fake records
FAKE_CASES = {
    "coverage_with_cutoff": lambda r, c: r.coverage_with_cutoff(
        _cov_aln(), [100, 50], cutoff=0.99),
    "per_base_coverage": lambda r, c: [
        c.per_base_coverage(np.array([0, 0]), np.array([0, 50]),
                            np.array([50, 50]), [100]),
        c.per_base_coverage(np.array([0, 0, 1]), np.array([0, 0, 5]),
                            np.array([50, 50, 300]), [100, 20])],
    "m_segments_empty": lambda r, c: c.m_segments(
        np.zeros(0), np.zeros(0), np.zeros(0), np.zeros(1)),
    "refine_by_reads": lambda r, c: r.refine_by_reads(FakeAln(
        tid=[0] * 4 + [1] * 4 + [5], lclip=[0, 0, 0, 0, 20, 20, 20, 0, 0],
        rclip=[0] * 9, nmatch=[100] * 9, read_len=[100] * 9),
        [500, 500, 10], cf_cutoff=0.5),
    "unique_names": lambda r, c: r.unique_names(["a", "b", "a", "c"]),
    "cnt_contig_linkage": lambda r, c: [
        r.cnt_contig_linkage(_link_aln(), [300, 300], ["A", "B"],
                             insert_size=200, sd=10, read_length=100),
        r.cnt_contig_linkage(_link_aln(), [300, 300], ["A", "B"],
                             insert_size=200, sd=10, read_length=100,
                             cov_cutoff=0.5),
        r.cnt_contig_linkage(_link_aln(), [300, 300], ["A", "B"],
                             insert_size=200, sd=10, read_length=100,
                             min_support=5)],
}


@pytest.mark.parametrize("case", list(FAKE_CASES))
def test_columnar_modes_match_jax(case):
    fn = FAKE_CASES[case]
    assert plain(fn(tref, tcov)) == plain(fn(jref, jcov))


@pytest.fixture(scope="module")
def contig_bam(tmp_path_factory):
    """A contig-vs-contig BAM: single-M full hits, clipped and indel
    CIGARs, a duplicate and a secondary record, an unmapped one, names
    out of and in fai order; read back by both packages with names and
    CIGARs kept."""
    refs = [("c0", 120), ("c1", 120), ("c2", 90), ("c3", 200)]
    rec = [
        dict(name="c1", flag=0, tid=0, pos=0, mapq=60, cigar=[("M", 120)]),
        dict(name="c0", flag=0, tid=1, pos=0, mapq=60, cigar=[("M", 120)]),
        dict(name="c2", flag=0, tid=3, pos=10, mapq=60,
             cigar=[("M", 60), ("D", 3), ("M", 30)]),
        dict(name="c3", flag=0, tid=2, pos=0, mapq=60,
             cigar=[("S", 50), ("M", 90), ("S", 60)]),
        dict(name="c2", flag=0x400, tid=0, pos=5, mapq=60,
             cigar=[("M", 88), ("I", 2)]),
        dict(name="c3", flag=0x100, tid=1, pos=0, mapq=0,
             cigar=[("M", 100), ("H", 100)]),
        dict(name="c9", flag=0, tid=3, pos=0, mapq=60, cigar=[("M", 50)]),
        dict(name="c0", flag=4, tid=-1, pos=-1, mapq=0, cigar=[]),
    ]
    lens = {"c0": 120, "c1": 120, "c2": 90, "c3": 200, "c9": 50}
    for r in rec:
        r.update(mtid=-1, mpos=-1, tlen=0, seq="A" * lens[r["name"]])
    path = str(tmp_path_factory.mktemp("bam") / "contigs.bam")
    jbam.write_bam(path, refs, rec)
    return (jbam.read_bam(path, keep_names=True, keep_cigars=True),
            tbam.read_bam(path, keep_names=True, keep_cigars=True),
            [n for n, _ in refs], [ln for _, ln in refs])


BAM_CASES = {
    "fully_mapped_mask": lambda r, a, n, ln: r.fully_mapped_mask(
        a, [120, 120, 90, 200, 90, 200, 50, 120], 0.9),
    "perfect_mapped_mask": lambda r, a, n, ln: r.perfect_mapped_mask(
        a, [120, 120, 90, 200, 90, 200, 50, 120]),
    "remove_dup_contigs": lambda r, a, n, ln: [
        r.remove_dup_contigs(a, n, ln, 0.9),
        r.remove_dup_contigs(a, n, ln, 0.9, rm_contained=True)],
    "remove_repeats_two_sets": lambda r, a, n, ln:
        r.remove_repeats_two_sets(a, n, ln, 0.9),
    "remove_repeats_one_set": lambda r, a, n, ln:
        r.remove_repeats_one_set(a, n, ln, 0.9),
    "remove_contained_contigs": lambda r, a, n, ln:
        r.remove_contained_contigs(a, n, ln, 0.9),
    "coverage_with_cutoff_exact": lambda r, a, n, ln:
        r.coverage_with_cutoff_exact(a, ln, 0.5, 100),
    "calc_coverage": lambda r, a, n, ln: r.calc_coverage(a, ln),
    "evaluate_with_benchmark": lambda r, a, n, ln:
        r.evaluate_with_benchmark(a, ln, cutoff=0.4),
}


@pytest.mark.parametrize("case", list(BAM_CASES))
def test_bam_modes_match_jax(contig_bam, case):
    jaln, taln, names, lens = contig_bam
    fn = BAM_CASES[case]
    assert plain(fn(tref, taln, names, lens)) == \
        plain(fn(jref, jaln, names, lens))


def test_exact_per_base_coverage_with_cigars_matches_jax(tmp_path):
    """tests/test_tools.py's deletion case: the exact M-segment pileup,
    the nmatch-span approximation and the segments, both packages."""
    refs = [("c0", 100)]
    recs = [dict(name="r0", flag=0, tid=0, pos=0, mapq=60,
                 cigar=[("M", 10), ("D", 5), ("M", 10)],
                 mtid=-1, mpos=-1, tlen=0, seq="A" * 20)]
    p = str(tmp_path / "cov.bam")
    tbam.write_bam(p, refs, recs)
    out = []
    for bam, cov in ((jbam, jcov), (tbam, tcov)):
        aln = bam.read_bam(p, keep_cigars=True)
        cig = (aln.cig_op, aln.cig_ln, aln.cig_off)
        out.append(plain([
            cov.per_base_coverage(aln.tid, aln.pos, aln.nmatch, [100],
                                  cigars=cig),
            cov.per_base_coverage(aln.tid, aln.pos, aln.nmatch, [100]),
            cov.m_segments(aln.pos, *cig)]))
    assert out[0] == out[1]
    assert out[1][0][1] == ("<i8", [20])


def test_classify_repeat_matches_jax(rng):
    a = rng.integers(0, 4, 120).astype(np.int8)
    cases = [(a, a), (a, jdna.revcomp(a)),
             (a, rng.integers(0, 4, 120).astype(np.int8)),
             (a[:70], np.concatenate([rng.integers(0, 4, 30).astype(np.int8),
                                      a[5:70]])),
             (a, a[:10])]
    got = [tref.classify_repeat(x, y, device="cpu") for x, y in cases]
    assert got == [jref.classify_repeat(x, y) for x, y in cases]
    assert [g[0] for g in got[:3]] == ["forward", "reverse", "none"]


def _scaffold_case(rng):
    """tests/test_tools.py's scaffold rows: an anchored overlap merge, a
    discarded negative-distance pair, the ave_pe filter, a reverse
    orientation, and chains of three contigs."""
    truth = rng.integers(0, 4, 720).astype(np.int8)
    A, B, C = truth[:300].copy(), truth[280:520].copy(), \
        rng.integers(0, 4, 200).astype(np.int8)
    D = truth[500:].copy()
    contigs, names = [A, B, C, D], ["A", "B", "C", "D"]

    def row(i1, n1, d1, i2, n2, d2, np_, dist):
        return (i1, n1, len(contigs[i1]), d1, i2, n2, len(contigs[i2]), d2,
                np_, dist, dist, dist)
    links = [
        [row(0, "A", "+", 1, "B", "+", 9, -20.0)],
        [row(0, "A", "+", 2, "C", "+", 9, -20.0)],
        [row(0, "A", "+", 1, "B", "+", 10, 15.0),
         row(0, "A", "+", 2, "C", "+", 2, 15.0)],
        [row(0, "A", "+", 1, "B", "-", 9, 5.0)],
        [row(0, "A", "+", 1, "B", "+", 9, -20.0),
         row(1, "B", "+", 3, "D", "+", 7, -20.0),
         row(2, "C", "-", 0, "A", "-", 4, 30.0)],
    ]
    return contigs, names, links


@pytest.mark.parametrize("chain", [False, True])
def test_build_scaffolds_matches_jax(rng, chain):
    contigs, names, links = _scaffold_case(rng)
    for ln in links:
        want = jscaf.build_scaffolds(contigs, names, ln, chain=chain)
        got = tscaf.build_scaffolds(contigs, names, ln, chain=chain,
                                    device="cpu")
        assert plain(got) == plain(want)
        assert plain(tscaf.merge_connections(contigs, names, ln,
                                             device="cpu")) == \
            plain(jscaf.merge_connections(contigs, names, ln))
    merged, _ = tscaf.build_scaffolds(contigs, names, links[0], chain=chain,
                                      device="cpu")
    assert merged[0][0] == "A$+$B$+$-20"
    if chain:
        got, _ = tscaf.build_scaffolds(contigs, names, links[4], chain=True,
                                       device="cpu")
        assert any(n.startswith("scaffold_chain_0_A_B_D") for n, _ in got)


def test_linkage_to_scaffolds_matches_jax(rng):
    """tests/test_tools.py's linkage case: -L rows from paired records
    feed -S, both packages."""
    truth = rng.integers(0, 4, 600).astype(np.int8)
    A, B = truth[:300].copy(), truth[310:].copy()
    aln = FakeAln(
        tid=[0] * 10, mtid=[1] * 10, pos=list(range(200, 250, 5)),
        mapq=[60] * 10, flag=[0x1 | 0x40 | 0x20] * 10,
        nmatch=[100] * 10, read_len=[100] * 10, lclip=[0] * 10,
        rclip=[0] * 10, mpos=[10] * 10, tlen=[0] * 10)
    out = []
    for ref, scaf, kw in ((jref, jscaf, {}), (tref, tscaf, {"device": "cpu"})):
        links = ref.cnt_contig_linkage(aln, [300, 290], ["A", "B"],
                                       insert_size=250, sd=20)
        out.append(plain([links, scaf.build_scaffolds([A, B], ["A", "B"],
                                                      links, **kw)]))
    assert out[0] == out[1]
    assert out[1][1][0][0][0].startswith("A$+$B$+$")
