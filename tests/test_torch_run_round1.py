"""Port parity of the Assembly+Pick driver, round 1: one 150-bp gap
that round 1 closes. JAX Preprocess + Collect build the workspace, then
the JAX package's and the port's `run_assembly_and_pick` (on the CPU)
must write the same picked_seqs.fa, picked_seqs.fa_ori.txt and
merge_info.txt byte for byte, with equal fills, extensions and contig
stores."""

from gappadder_tpu import dna as jdna
from gappadder_tpu_torch.pipeline import rescue

from test_torch_run_scenarios import (Calls, build, one_torch_thread,  # noqa: F401
                                 run_both_and_compare)


def test_round1_gap_matches_jax(tmp_path, rng, monkeypatch):
    cfg, tcfg, truth, (gs, ge) = build(tmp_path, rng)
    resc = Calls(monkeypatch, rescue, "rescue_both_unmapped")
    fills, exts, store = run_both_and_compare(cfg, tcfg)
    # round 1 closed it: no rescue, no extension
    assert list(fills) == [0] and exts == {} and resc.results == []
    want = truth[gs - cfg.flank_margin:ge + cfg.flank_margin]
    assert jdna.decode(fills[0][0]) == want
    assert store[0][2] >= 1


def test_fastq_scan_and_fasta_writers_match_jax(tmp_path):
    """The driver's I/O: the FASTQ index (name hashes, lengths, byte
    offsets; normalized names) and the FASTA writers' bytes (80-column
    lines, an empty record) equal the JAX package's."""
    import numpy as np
    from gappadder_tpu.io import fasta as jfasta
    from gappadder_tpu.io import fastq as jfastq
    from gappadder_tpu_torch.io import fasta, fastq
    fq = tmp_path / "r.fq"
    fq.write_bytes(b"@r1/1 extra\nACGTN\n+\nIIIII\n@r2/2\nAC\n+\nII\n"
                   b"@r3\nACGTACGTAC\n+r3\nIIIIIIIIII\n")
    got, want = fastq.scan_fastq(fq), jfastq.scan_fastq(fq)
    for f in ("name_hash", "length", "seq_off", "qual_off", "name_off",
              "name_len"):
        np.testing.assert_array_equal(getattr(got, f), getattr(want, f))
    assert got.max_len == want.max_len
    assert [got.get_name(i) for i in range(3)] == [b"r1", b"r2", b"r3"]
    assert fastq.fnv1a(b"r1") == jfastq.fnv1a(b"r1")
    assert got.get_seq(0).tolist() == want.get_seq(0).tolist()
    recs = [("a", np.arange(170) % 5), ("empty", ""), ("s", "ACGTN" * 40)]
    assert fasta.fasta_string(recs) == jfasta.fasta_string(recs)
    fasta.write_fasta(tmp_path / "a.fa", recs)
    jfasta.write_fasta(tmp_path / "b.fa", recs)
    assert (tmp_path / "a.fa").read_bytes() == (tmp_path / "b.fa").read_bytes()
    g, jg = fasta.read_fasta(tmp_path / "a.fa"), jfasta.read_fasta(
        tmp_path / "b.fa")
    assert g.names == jg.names and g.seq.tolist() == jg.seq.tolist()
    assert [n for n, _ in fasta.iter_fasta(tmp_path / "a.fa")] == \
        ["a", "empty", "s"]
