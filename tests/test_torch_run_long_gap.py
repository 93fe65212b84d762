"""Port parity of the Assembly+Pick driver past Lc = 2048:
tests/test_end_to_end.py::test_close_gap_over_2kb's setup (a 2.6 kb gap
in 8 kb, 4,000 pairs of a 700-bp insert library) through the JAX
package's and the port's `run_assembly_and_pick` (on the CPU). The
contigs pass 2,048 bases, so the merge's and Pick's queries span three
or more SW strips of 1,024 rows; every output must be equal byte for
byte and the fill must be the planted bases."""

from gappadder_tpu import dna as jdna
from gappadder_tpu_torch.ops import sw_cuda, swutil

from test_torch_run_scenarios import (build, one_torch_thread,  # noqa: F401
                                      run_both_and_compare)


def test_gap_over_2kb_matches_jax(tmp_path, rng, monkeypatch):
    cfg, tcfg, truth, (gs, ge) = build(tmp_path, rng, gap_len=2600, L=8000,
                                       n_pairs=4000, insert=700, std=60)
    rows = []
    inner = swutil.sw_batch_cuda

    def record(q, *a, **kw):
        rows.append(q.shape[1])
        return inner(q, *a, **kw)
    monkeypatch.setattr(swutil, "sw_batch_cuda", record)
    fills, exts, _ = run_both_and_compare(cfg, tcfg)
    assert list(fills) == [0] and exts == {}
    fill = jdna.decode(fills[0][0])
    assert fill == truth[gs - cfg.flank_margin:ge + cfg.flank_margin]
    assert len(fill) > 2048
    # the merge's and Pick's queries reached three strips of rows
    assert max(sw_cuda.strips(r) for r in rows) >= 3
