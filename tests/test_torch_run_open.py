"""Port parity of the Assembly+Pick driver on a gap left open after
round 2: a 600-bp gap whose both-unmapped pairs are cut to those lying
left of its middle, so rescue adds reads, round 2 runs and still cannot
close it; the HQ pseudo-contig pass, the relaxed final pick and its
extension fallback run. Both packages' drivers must give the same files,
fills, extensions and contig stores."""

from gappadder_tpu_torch.pipeline import rescue, run

from test_torch_run_scenarios import (Calls, build, one_torch_thread,  # noqa: F401
                                 run_both_and_compare)


def test_open_gap_matches_jax(tmp_path, rng, monkeypatch):
    cfg, tcfg, _truth, _gap = build(tmp_path, rng, open_gap=True,
                                    gap_len=600, L=3000, n_pairs=300)
    resc = Calls(monkeypatch, rescue, "rescue_both_unmapped")
    hq = Calls(monkeypatch, rescue, "hq_pseudo_contigs")
    picks = Calls(monkeypatch, run, "_pick_gaps")
    fills, exts, _ = run_both_and_compare(cfg, tcfg)
    assert len(resc.results[0].get(0, [])) > 0
    assert len(hq.results) == 1
    assert len(picks.results) == 3        # round 1, round 2, final
    assert fills == {} and list(exts) == [0] and len(exts[0][0]) > 0
