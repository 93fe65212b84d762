"""Port parity of the non-fused Assembly batch (`tpu.fused=False`, the
JAX package's host-glued path): `_pad_batch`, `gap_distinct_kmers`,
`count_gap_kmers` and `assemble_gap_batch` at tests/test_fused.py's
setup, their cap growth and warnings, and the driver with
`tpu.fused=False`, whose picked_seqs.fa must equal both the JAX
package's non-fused run and the port's fused run. All on the CPU, with
exact equality."""

import dataclasses
import shutil

import numpy as np
import pytest

from gappadder_tpu.io import fastq as jfastq
from gappadder_tpu.pipeline import assemble as jasm
from gappadder_tpu.pipeline import run as jrun
from gappadder_tpu.utils import log as jlog
from gappadder_tpu_torch.io import fastq as tfastq
from gappadder_tpu_torch.pipeline import assemble as tasm
from gappadder_tpu_torch.pipeline import run as trun
from gappadder_tpu_torch.pipeline.workspace import Workspace
from gappadder_tpu_torch.utils import log as tlog

from test_torch_run_scenarios import (build, one_torch_thread,  # noqa: F401
                                      port_config, run_both_and_compare)

CAP_EVENTS = ("kmer_table_grow", "kmer_table_truncated", "dbg_node_cap_grow",
              "unitig_slots_grow", "contig_len_truncated",
              "reads_per_gap_truncated")


def non_fused(cfg, **kw):
    return dataclasses.replace(
        cfg, tpu=dataclasses.replace(cfg.tpu, fused=False), **kw)


@pytest.fixture(scope="module")
def batch(tmp_path_factory):
    """tests/test_fused.py's setup (600 pairs, 0.2 % errors) through the
    JAX Preprocess and Collect; the one gap's padded read batch from
    both packages' `_pad_batch` on their own FASTQ indexes."""
    tmp = tmp_path_factory.mktemp("nonfused")
    cfg, tcfg, truth, span = build(tmp, np.random.default_rng(0),
                                   n_pairs=600, err_rate=0.002)
    rec = dict(np.load(tmp / "work" / "recruits.npz"))
    lib = cfg.libraries[0]
    jrs = [(jfastq.scan_fastq(lib.left_fq), jfastq.scan_fastq(lib.right_fq))]
    trs = [(tfastq.scan_fastq(lib.left_fq), tfastq.scan_fastq(lib.right_fq))]
    per_gap = jrun.build_gap_read_arrays(rec, jrs, 1)
    R, md = jrun._bucket_of(len(per_gap[0]))
    L = 101
    padded = [0, -1, -1]
    want = jrun._pad_batch(padded, per_gap, jrs, R, L)
    got = trun._pad_batch(padded, trun.build_gap_read_arrays(rec, trs, 1),
                          trs, R, L)
    for a, b in zip(got, want):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)
    assert int(want[2][0]) == len(per_gap[0]) > 100
    return cfg, tcfg, want, md, tmp


def _same_contigs(a, b):
    for f in ("seq", "length", "count"):
        x, y = np.asarray(getattr(a, f)), np.asarray(getattr(b, f))
        assert x.dtype == y.dtype and x.shape == y.shape, f
        np.testing.assert_array_equal(x, y, err_msg=f)
    assert a.names == b.names


@pytest.mark.parametrize("k,min_count,md", [(25, 0, 4096), (31, -1, 4096),
                                            (25, 3, 4096), (31, 0, 256)])
def test_gap_distinct_kmers_matches_jax(batch, k, min_count, md):
    _, _, (seq, rlen, nreads), _, _ = batch
    want = jasm.gap_distinct_kmers(seq, rlen, nreads, k, md,
                                   min_count=min_count)
    got = tasm.gap_distinct_kmers(seq, rlen, nreads, k, md,
                                  min_count=min_count, device="cpu")
    for a, b in zip(got, want):
        b = np.asarray(b)
        assert a.dtype == b.dtype and a.shape == b.shape
        np.testing.assert_array_equal(a, b)
    assert want[3].any() == (md == 256)     # a 256 table saturates


def test_count_gap_kmers_and_batch_match_jax(batch):
    cfg, tcfg, (seq, rlen, nreads), md, _ = batch
    for (k, _sub) in cfg.kmers:
        want = jasm.count_gap_kmers(cfg, seq, rlen, nreads, k, md)
        got = tasm.count_gap_kmers(tcfg, seq, rlen, nreads, k, md,
                                   device="cpu")
        for a, b in zip(got, want):
            np.testing.assert_array_equal(a, np.asarray(b))
    want = jasm.assemble_gap_batch(cfg, seq, rlen, nreads, max_distinct=md)
    got = tasm.assemble_gap_batch(tcfg, seq, rlen, nreads, max_distinct=md,
                                  device="cpu")
    _same_contigs(got, want)
    assert int(got.count[0]) >= 1 and got.count[1:].tolist() == [0, 0]


@pytest.mark.parametrize("kw,md,fires", [
    (dict(max_unitigs=1, bubble_pop_rounds=1), 64,
     ("kmer_table_grow", "unitig_slots_grow")),
    (dict(max_distinct_kmers=128), 1024,
     ("kmer_table_truncated", "dbg_node_cap_grow")),
    (dict(max_contig_len=64), 1024, ("contig_len_truncated",)),
])
def test_cap_growth_and_warnings_match_jax(batch, kw, md, fires):
    """A small start table and one unitig slot grow; fixed caps warn and
    truncate; the DBG node cap grows past a fixed table. Each event
    counts as often as in the JAX package, and the contigs are equal."""
    cfg, tcfg, (seq, rlen, nreads), _, _ = batch
    cfg, tcfg = (dataclasses.replace(c, **kw) for c in (cfg, tcfg))
    jlog.reset_cap_events()
    want = jasm.assemble_gap_batch(cfg, seq, rlen, nreads, max_distinct=md)
    tlog.reset_cap_events()
    got = tasm.assemble_gap_batch(tcfg, seq, rlen, nreads, max_distinct=md,
                                  device="cpu")
    _same_contigs(got, want)
    counts = {e: tlog.cap_events(e) for e in CAP_EVENTS}
    assert counts == {e: jlog.cap_events(e) for e in CAP_EVENTS}
    assert all(counts[e] > 0 for e in fires), counts


def test_non_fused_driver_matches_jax_and_fused(batch, tmp_path):
    """The driver with tpu.fused=False: every output equal to the JAX
    package's non-fused driver, and picked_seqs.fa, its _ori.txt and
    merge_info.txt equal to the port's fused driver on the same
    workspace."""
    cfg, tcfg, _, _, tmp = batch
    fused_dir = str(tmp_path / "fused")
    shutil.copytree(tcfg.workdir, fused_dir)
    fills, _, _ = run_both_and_compare(non_fused(cfg),
                                       non_fused(tcfg))
    assert list(fills) == [0]
    ffills, _, _ = trun.run_assembly_and_pick(
        dataclasses.replace(tcfg, working_folder=fused_dir),
        Workspace(fused_dir), device="cpu")
    for name in ("picked_seqs.fa", "picked_seqs.fa_ori.txt",
                 "merge_info.txt"):
        with open(Workspace(tcfg.workdir).path(name), "rb") as a, \
                open(Workspace(fused_dir).path(name), "rb") as b:
            assert a.read() == b.read(), name
    assert ffills[0][0].tolist() == fills[0][0].tolist()


@pytest.mark.parametrize("kw,event", [
    (dict(max_reads_per_gap=64), "reads_per_gap_truncated"),
    (dict(max_distinct_kmers=128), "kmer_table_truncated")])
def test_driver_cap_warnings_match_jax(tmp_path, rng, kw, event):
    """tests/test_end_to_end.py's two warning cases (a reads-per-gap cap,
    a fixed k-mer table) through both non-fused drivers: the warning
    fires, as often as in the JAX package, and every output is equal."""
    cfg, tcfg, _, _ = build(tmp_path, rng, n_pairs=600)
    jlog.reset_cap_events()
    tlog.reset_cap_events()
    run_both_and_compare(non_fused(cfg, **kw), non_fused(tcfg, **kw))
    assert tlog.cap_events(event) == jlog.cap_events(event) > 0
