"""Port parity of the Assembly batch's k-mer count and cap growth at
tests/test_fused.py's setup (600 pairs, 0.2 % errors): block 3's
distinct-k-mer table (`slice._distinct_kmers`) at four (k, count
filter, table width) settings, saturation included; the batch
(`fused.assemble_batch`) on the setup's gap at the shipped caps and at
three cap settings that grow or truncate; and the driver at two capped
settings. Each held to the JAX package on the CPU, with exact equality
of the contigs and of every capacity event's count."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gappadder_tpu.io import fastq as jfastq
from gappadder_tpu.parallel import slice as jsl
from gappadder_tpu.parallel.mesh import make_mesh
from gappadder_tpu.pipeline import fused as jfused
from gappadder_tpu.pipeline import run as jrun
from gappadder_tpu.utils import log as jlog
from gappadder_tpu_torch.io import fastq as tfastq
from gappadder_tpu_torch.parallel import slice as tsl
from gappadder_tpu_torch.pipeline import fused as tfused
from gappadder_tpu_torch.pipeline import run as trun
from gappadder_tpu_torch.utils import log as tlog

from test_torch_run_scenarios import (build, one_torch_thread,  # noqa: F401
                                      run_both_and_compare)

CAP_EVENTS = ("kmer_table_grow", "kmer_table_truncated", "dbg_node_cap_grow",
              "unitig_slots_grow", "contig_len_grow", "contig_len_truncated",
              "reads_per_gap_truncated")
L = 101
BATCH = [0, -1, -1]     # the one gap and two padding slots


@pytest.fixture(scope="module")
def batch(tmp_path_factory):
    """tests/test_fused.py's setup through the JAX Preprocess and
    Collect: both packages' configs, the gap's recruits in each
    package's read sets, its reads bucket and starting table width, and
    the batch's padded reads [3, R, L] (the JAX package's
    `run._pad_batch`)."""
    tmp = tmp_path_factory.mktemp("batch_caps")
    cfg, tcfg, _truth, _span = build(tmp, np.random.default_rng(0),
                                     n_pairs=600, err_rate=0.002)
    rec = dict(np.load(tmp / "work" / "recruits.npz"))
    lib = cfg.libraries[0]
    jrs = [(jfastq.scan_fastq(lib.left_fq), jfastq.scan_fastq(lib.right_fq))]
    trs = [(tfastq.scan_fastq(lib.left_fq), tfastq.scan_fastq(lib.right_fq))]
    per_gap = jrun.build_gap_read_arrays(rec, jrs, 1)
    assert trun.build_gap_read_arrays(rec, trs, 1) == per_gap
    R, md = trun._bucket_of(len(per_gap[0]))
    assert (R, md) == jrun._bucket_of(len(per_gap[0]))
    padded = jrun._pad_batch(BATCH, per_gap, jrs, R, L)
    assert int(padded[2][0]) == len(per_gap[0]) > 100
    return cfg, tcfg, per_gap, jrs, trs, R, md, padded


def _jax_batch(cfg, per_gap, jrs, R, md):
    mesh = make_mesh(shape=(1,), axes=("dp",), devices=jax.devices()[:1])
    jlog.reset_cap_events()
    out = jfused.assemble_batch(cfg, mesh, BATCH, per_gap, jrs, R, L,
                                max_distinct=md)
    return out, {e: jlog.cap_events(e) for e in CAP_EVENTS}


def _port_batch(tcfg, per_gap, trs, R, md):
    tlog.reset_cap_events()
    out = tfused.assemble_batch(tcfg, BATCH, per_gap, trs, R, L,
                                max_distinct=md, device="cpu")
    return out, {e: tlog.cap_events(e) for e in CAP_EVENTS}


def _same_contigs(a, b):
    for f in ("seq", "length", "count"):
        x, y = np.asarray(getattr(a, f)), np.asarray(getattr(b, f))
        assert x.dtype == y.dtype and x.shape == y.shape, f
        np.testing.assert_array_equal(x, y, err_msg=f)
    assert a.names == b.names


@pytest.mark.parametrize("k,min_count,md", [(25, 0, 4096), (31, -1, 4096),
                                            (25, 3, 4096), (31, 0, 256)])
def test_distinct_kmers_matches_jax(batch, k, min_count, md):
    """The table, its strings, counts and distinct mask; a 256 table
    saturates (the lexicographically largest k-mers fall off)."""
    *_, (seq, rlen, _nreads) = batch
    jdims = jsl.SliceDims(n_shards=1, n_gaps=len(BATCH),
                          gaps_per_shard=len(BATCH), entry_cap=1,
                          reads_per_gap=seq.shape[1], kset=((k, k - 2),),
                          max_distinct=md, min_kmer_count=min_count)
    tdims = tsl.dims_from_fields(dataclasses.asdict(jdims))
    want = jsl._distinct_kmers(jnp.asarray(seq), jnp.asarray(rlen), k, jdims)
    with torch.no_grad():
        got = tsl._distinct_kmers(torch.from_numpy(seq),
                                  torch.from_numpy(rlen), k, tdims)
    for name, a, b in zip(("acc", "kstr", "nk", "cnt", "distinct"), got,
                          want):
        b = np.asarray(b)
        assert a.shape == b.shape, name
        np.testing.assert_array_equal(a.numpy().astype(np.int64),
                                      b.astype(np.int64), err_msg=name)
    nk = got[2].numpy()
    assert nk[0] > 0 and nk[1:].tolist() == [0, 0]
    assert (nk[0] == md) == (md == 256)


def test_assemble_batch_on_the_gap_matches_jax(batch):
    cfg, tcfg, per_gap, jrs, trs, R, md, _ = batch
    want, want_ev = _jax_batch(cfg, per_gap, jrs, R, md)
    got, got_ev = _port_batch(tcfg, per_gap, trs, R, md)
    _same_contigs(got, want)
    assert got_ev == want_ev
    assert int(got.count[0]) >= 1 and got.count[1:].tolist() == [0, 0]


@pytest.mark.parametrize("kw,md,fires", [
    (dict(max_unitigs=1, bubble_pop_rounds=1), 64,
     ("kmer_table_grow", "unitig_slots_grow")),
    (dict(max_distinct_kmers=128), 1024, ("kmer_table_truncated",)),
    (dict(max_contig_len=64), 1024, ("contig_len_truncated",)),
])
def test_cap_growth_and_warnings_match_jax(batch, kw, md, fires):
    """A small start table and one unitig slot grow; a fixed table and a
    fixed contig length warn and truncate. Each event counts as often
    as in the JAX package, and the contigs are equal."""
    cfg, tcfg, per_gap, jrs, trs, R, _, _ = batch
    cfg, tcfg = (dataclasses.replace(c, **kw) for c in (cfg, tcfg))
    want, want_ev = _jax_batch(cfg, per_gap, jrs, R, md)
    got, got_ev = _port_batch(tcfg, per_gap, trs, R, md)
    _same_contigs(got, want)
    assert got_ev == want_ev
    assert all(got_ev[e] > 0 for e in fires), got_ev


@pytest.mark.parametrize("kw,event", [
    (dict(max_reads_per_gap=64), "reads_per_gap_truncated"),
    (dict(max_distinct_kmers=128), "kmer_table_truncated")])
def test_driver_cap_warnings_match_jax(tmp_path, rng, kw, event):
    """tests/test_end_to_end.py's two warning cases (a reads-per-gap cap,
    a fixed k-mer table) through both drivers: the warning fires, as
    often as in the JAX package, and every output is equal."""
    cfg, tcfg, _, _ = build(tmp_path, rng, n_pairs=600)
    jlog.reset_cap_events()
    tlog.reset_cap_events()
    run_both_and_compare(dataclasses.replace(cfg, **kw),
                         dataclasses.replace(tcfg, **kw))
    assert tlog.cap_events(event) == jlog.cap_events(event) > 0
