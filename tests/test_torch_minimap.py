"""The port's minimizer mapper (`gappadder_tpu_torch.ops.minimap`, host
numpy) against the JAX package's on the cases of tests/test_minimap.py,
and the self-mapping Collect (a library with no BAM) of both packages on
the same draft and FASTQs. Exact equality."""

import dataclasses

import numpy as np
import pytest

from gappadder_tpu import dna as jdna
from gappadder_tpu.io import fasta as jfasta
from gappadder_tpu.io import fastq as jfastq
from gappadder_tpu.ops import minimap as jminimap
from gappadder_tpu.pipeline import collect as jcollect
from gappadder_tpu.pipeline import preprocess as jpreprocess
from gappadder_tpu.pipeline.workspace import Workspace as JWorkspace
from gappadder_tpu_torch.io import fasta as tfasta
from gappadder_tpu_torch.io import fastq as tfastq
from gappadder_tpu_torch.ops import minimap as tminimap
from gappadder_tpu_torch.pipeline import collect as tcollect
from gappadder_tpu_torch.pipeline import preprocess as tpreprocess
from gappadder_tpu_torch.pipeline.workspace import Workspace

from test_end_to_end import _setup
from test_minimap import make_genome, pack
from test_torch_collect import assert_collect_equal
from test_torch_run_scenarios import port_config


def _port_genome(g):
    return tfasta.Genome(seq=g.seq.copy(), offsets=g.offsets.copy(),
                         lengths=g.lengths.copy(), names=list(g.names))


def same_fields(a, b):
    for f in dataclasses.fields(a):
        x, y = getattr(a, f.name), getattr(b, f.name)
        if isinstance(x, np.ndarray):
            assert x.dtype == y.dtype, f.name
            np.testing.assert_array_equal(x, y, err_msg=f.name)
        else:
            assert x == y, f.name


def _index_pair(g, **kw):
    return jminimap.build_index(g, **kw), tminimap.build_index(
        _port_genome(g), **kw)


def _reads(rng, g):
    """test_minimap's reads: forward and reverse placements on both
    scaffolds, a 1-base deletion, reads into a planted N-run, junk."""
    reads = []
    for st in (100, 700, 1500, 2800):
        reads.append(g.seq[st:st + 100].copy())
        reads.append(jdna.revcomp(g.seq[st + 7:st + 107]))
    reads.append(np.concatenate([g.seq[900:950], g.seq[951:1001]]))
    r1 = g.seq[940:1040].copy()
    r1[60:] = rng.integers(0, 4, 40)
    reads.append(r1)
    reads.append(rng.integers(0, 4, 100).astype(np.int8))
    reads.append(g.seq[2000:2037].copy())
    return pack(reads)


@pytest.mark.parametrize("repeat", [False, True])
def test_map_reads_matches_jax(rng, repeat):
    g = make_genome(rng)
    if repeat:
        g.seq[2000:2300] = g.seq[500:800]          # a 300 bp repeat
    g.seq[1200:1300] = jdna.N                       # an N-run
    ji, ti = _index_pair(g)
    same_fields(ji, ti)
    seq, ln = _reads(rng, g)
    want = jminimap.map_reads(g, ji, seq, ln)
    got = tminimap.map_reads(_port_genome(g), ti, seq, ln)
    same_fields(want, got)
    assert (got.gstart >= 0).sum() >= 8 and (got.gstart < 0).any()


def test_index_chunk_size_invariance_matches_jax(rng):
    g = make_genome(rng, lengths=(5000,))
    for chunk in (256, 1000, 1 << 30):
        ji, ti = _index_pair(g, chunk=chunk)
        same_fields(ji, ti)
    h = jminimap.canonical_kmer_hashes(g.seq[:400], 17)
    t = tminimap.canonical_kmer_hashes(g.seq[:400], 17)
    for x, y in zip(h, t):
        np.testing.assert_array_equal(x, y)


def _readsets(entries):
    names = [n.encode() for n, _ in entries]
    seq, ln = pack([s for _, s in entries])
    kw = dict(seq=seq, length=ln, qual=np.full(seq.shape, 73, np.uint8),
              names=names)
    return (jfastq.ReadSet(name_hash=jfastq._fnv1a_batch(names), **kw),
            tfastq.ReadSet(name_hash=tfastq._fnv1a_batch(names), **kw))


def test_map_library_matches_jax(rng):
    g = make_genome(rng, lengths=(3000, 1500))
    ji, ti = _index_pair(g)
    lj, lt = _readsets([("p0", g.seq[500:600].copy()),
                        ("p1", rng.integers(0, 4, 100).astype(np.int8)),
                        ("p2", g.seq[3100:3200].copy())])
    rj, rt = _readsets([("p0", jdna.revcomp(g.seq[700:800])),
                        ("p1", jdna.revcomp(g.seq[1500:1600])),
                        ("p2", jdna.revcomp(g.seq[1000:1100]))])
    want = jminimap.map_library(g, ji, lj, rj)
    got = tminimap.map_library(_port_genome(g), ti, lt, rt)
    assert want.refs == got.refs and got.n == 6
    for k in ("tid", "pos", "flag", "mapq", "mtid", "mpos", "tlen", "lclip",
              "rclip", "nmatch", "read_len", "name_hash"):
        np.testing.assert_array_equal(getattr(want, k), getattr(got, k), k)


def test_selfmap_collect_matches_jax(tmp_path, rng):
    """bam=None: both packages map the reads with their own mapper and
    collect; recruits, both-unmapped rows and per-gap FASTQs equal."""
    cfg, _truth, _span = _setup(tmp_path, rng)
    cfg = dataclasses.replace(cfg, libraries=(dataclasses.replace(
        cfg.libraries[0], bam=None),))
    jws = JWorkspace(cfg.workdir)
    genome = jfasta.read_fasta(cfg.draft_genome)
    jpreprocess.run_preprocess(cfg, jws, genome=genome)
    jcollect.run_collect(cfg, jws, genome=genome, write_parity_files=True)
    tcfg = port_config(cfg, str(tmp_path / "port_work"))
    tws = Workspace(tcfg.workdir)
    tpreprocess.run_preprocess(tcfg, tws, device="cpu")
    rec, readsets = tcollect.run_collect(tcfg, tws, write_parity_files=True,
                                         device="cpu")
    assert_collect_equal(jws, tws)
    assert len(rec["gap"]) > 50
    assert isinstance(readsets[0][0], tfastq.ReadSet)
