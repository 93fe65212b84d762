"""Port parity of the Assembly+Pick driver through rescue and round 2:
tests/test_end_to_end.py's setup with a 700-bp gap, whose middle lies
beyond the reach of the mates of reads anchored in the flanks, so only
both-unmapped pairs cover it (at this seed round 1 already closes the
450-bp gap of test_close_large_gap_needs_rescue). Both packages'
drivers must give the same files, fills, extensions and contig stores,
and the port's rescue must add reads and round 2 close the gap."""

from gappadder_tpu import dna as jdna
from gappadder_tpu_torch.pipeline import rescue, run

from test_torch_run_scenarios import (Calls, build, one_torch_thread,  # noqa: F401
                                 run_both_and_compare)


def test_rescue_gap_matches_jax(tmp_path, rng, monkeypatch):
    cfg, tcfg, truth, (gs, ge) = build(tmp_path, rng, gap_len=700, L=3000,
                                       n_pairs=400)
    resc = Calls(monkeypatch, rescue, "rescue_both_unmapped")
    asm = Calls(monkeypatch, run, "_assemble_gaps")
    fills, exts, _ = run_both_and_compare(cfg, tcfg)
    assert len(resc.results) == 1 and len(resc.results[0].get(0, [])) > 0
    assert len(asm.results) == 2          # round 1, then round 2
    want = truth[gs - cfg.flank_margin:ge + cfg.flank_margin]
    assert list(fills) == [0] and jdna.decode(fills[0][0]) == want
    assert exts == {}
