"""Port parity of the shipped Assembly batch: `gappadder_tpu_torch`'s
`fused.assemble_batch(device="cpu")` against the JAX
`fused.assemble_batch` on a one-device mesh, on the reads and per-gap
recruits of the planted scenario. Contigs (`seq`, `length`, `count`),
their `<k>_<sub_k>_<i>` names and the capacity events must be equal."""

import numpy as np
import pytest
import jax

from gappadder_tpu.config import Config as JConfig
from gappadder_tpu.parallel.mesh import make_mesh
from gappadder_tpu.pipeline import fused as jfused
from gappadder_tpu.utils import log as jlog
from gappadder_tpu_torch.config import Config
from gappadder_tpu_torch.parallel import slice as sl
from gappadder_tpu_torch.pipeline import fused, run
from gappadder_tpu_torch.utils import log

from test_torch_run_scenarios import one_torch_thread  # noqa: F401

CAP_KEYS = ("kmer_table_grow", "kmer_table_truncated", "dbg_node_cap_grow",
            "unitig_slots_grow", "contig_len_grow", "contig_len_truncated")
SCENARIOS = {
    "toy": (dict(gaps_per_shard=2), ((17, 15),), {}, None),
    "skewed_two_settings": (dict(gaps_per_shard=3, gap_len=(64, 160)),
                            ((17, 15), (21, 19)), {}, None),
    # starts md at 256 below the ~560 distinct k-mers of a 480 bp gap,
    # with one unitig slot: the k-mer table, the unitig slots and the
    # contig length (512 < the 560 bp unitig) all have to grow
    "caps_grow": (dict(gaps_per_shard=2, gap_len=480), ((17, 15),),
                  dict(max_unitigs=1), 256),
}


def _scenario(name):
    data_kw, kset, cfg_kw, md = SCENARIOS[name]
    dims, args = sl.example_data(1, kset=kset, **data_kw)
    rowtab = sl.run_step(dims, args, device="cpu")[4].numpy()
    readsets, per_gap, _gaps = sl.example_reads(args, rowtab)
    R, md0 = run._bucket_of(max(len(p) for p in per_gap))
    kw = dict(draft_genome="draft.fa", kmers=kset, **cfg_kw)
    batch = list(range(dims.n_gaps)) + [-1]       # a padding slot too
    L = args[22].shape[1]
    return kw, batch, per_gap, readsets, R, L, md or md0


def _jax_batch(kw, batch, per_gap, readsets, R, L, md):
    mesh = make_mesh(shape=(1,), axes=("dp",), devices=jax.devices()[:1])
    jlog.reset_cap_events()
    out = jfused.assemble_batch(JConfig(**kw), mesh, batch, per_gap,
                                readsets, R, L, max_distinct=md)
    return out, {k: jlog.cap_events(k) for k in CAP_KEYS}


@pytest.mark.parametrize("name", list(SCENARIOS))
def test_assemble_batch_matches_jax(name):
    kw, batch, per_gap, readsets, R, L, md = _scenario(name)
    want, want_ev = _jax_batch(kw, batch, per_gap, readsets, R, L, md)
    log.reset_cap_events()
    got = fused.assemble_batch(Config(**kw), batch, per_gap, readsets, R, L,
                               max_distinct=md, device="cpu")
    got_ev = {k: log.cap_events(k) for k in CAP_KEYS}
    for f in ("seq", "length", "count"):
        g, w = getattr(got, f), np.asarray(getattr(want, f))
        assert g.dtype == w.dtype and g.shape == w.shape, f
        np.testing.assert_array_equal(g, w, err_msg=f)
    assert got.names == want.names
    assert got_ev == want_ev
    if name == "caps_grow":
        for k in ("kmer_table_grow", "unitig_slots_grow", "contig_len_grow"):
            assert got_ev[k] >= 1, k


def test_assemble_batch_closes_the_planted_gaps():
    kw, batch, per_gap, readsets, R, L, md = _scenario("skewed_two_settings")
    got = fused.assemble_batch(Config(**kw), batch, per_gap, readsets, R, L,
                               max_distinct=md, device="cpu")
    assert got.count[-1] == 0                    # the padding slot
    assert (got.count[:-1] >= 2).all()
    assert all(n.split("_")[:2] in (["17", "15"], ["21", "19"])
               for names in got.names for n in names)


def test_config_loads_like_jax(tmp_path):
    """The same reference-schema JSON loads into equal configurations
    (the example config, and one that sets every parameter field)."""
    import dataclasses
    import json
    import pathlib
    from gappadder_tpu.config import load_config as jload
    from gappadder_tpu_torch.config import config_from_dict, load_config
    data = json.loads((pathlib.Path(__file__).parents[1] / "examples" /
                       "configuration.json").read_text())
    path = tmp_path / "configuration.json"
    path.write_text(json.dumps(data))
    assert dataclasses.asdict(load_config(str(path))) == \
        dataclasses.asdict(jload(str(path)))
    data["parameters"].update(
        min_gap_size=50, flank_length=200, max_unitigs=8, pick_max_hits=1,
        max_distinct_kmers=4096, min_kmer_count=-1, verbose=1)
    data["tpu"] = {"gap_batch": 16, "fused": False, "mesh_shape": [2, 2],
                   "mesh_axes": ["dp", "mp"]}
    from gappadder_tpu.config import config_from_dict as jfrom
    got = config_from_dict(data, base_dir=str(tmp_path))
    assert dataclasses.asdict(got) == \
        dataclasses.asdict(jfrom(data, base_dir=str(tmp_path)))
    assert got.tpu.gap_batch == 16 and got.pick_max_hits == 1


def test_gap_read_arrays_and_read_store_match_jax():
    from gappadder_tpu.io.fastq import ReadSet as JReadSet
    from gappadder_tpu.pipeline import run as jrun
    rng = np.random.default_rng(5)
    n = 40
    rec = {"gap": rng.integers(0, 6, n), "side": rng.integers(0, 2, n),
           "lib": rng.integers(0, 2, n), "row": rng.integers(0, 100, n)}
    assert run.build_gap_read_arrays(rec, None, 7) == \
        jrun.build_gap_read_arrays(rec, None, 7)
    _dims, args = sl.example_data(1, gaps_per_shard=1)
    rowtab = sl.run_step(_dims, args, device="cpu")[4].numpy()
    (rs, _), = sl.example_reads(args, rowtab)[0]
    js = JReadSet(rs.seq, rs.length, rs.qual, rs.name_hash, rs.names)
    assert rs.n == js.n
    for row in (0, rs.n // 2, rs.n - 1):
        np.testing.assert_array_equal(rs.get_seq(row), js.get_seq(row))
        np.testing.assert_array_equal(rs.get_qual(row), js.get_qual(row))
        assert rs.get_name(row) == js.get_name(row)
