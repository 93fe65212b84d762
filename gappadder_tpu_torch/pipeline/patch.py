"""Patch stage: splice the picked gap sequences back into the scaffolds
(counterpart of gappadder_tpu/pipeline/patch.py, and of the JAX CLI's
Patch step, which reads the fills back from picked_seqs.fa and writes
filled_scaffolds.fa).

Each gap's N-run is replaced by its picked fill; gaps without a pick
keep their Ns. Host numpy: nothing here runs on a device.
"""

from __future__ import annotations

import os

import numpy as np

from ..io import fasta


def patch_scaffolds(genome: fasta.Genome, gaps: dict[str, np.ndarray],
                    fills: dict[int, np.ndarray], margin: int = 5):
    """Return a list of (name, codes) patched scaffolds.

    fills: {gap_index -> int8 fill codes} (full closures only:
    extensions stay out of the scaffold).

    A picked fill is the contig span between the flank alignments: it
    covers truth positions [start - margin, end + margin), since the
    flanks stop `margin` bases short of the N-run. It is spliced over
    exactly that range. (The reference's manual patcher splices over
    [start, end + 1), duplicating the margins and dropping one base;
    PARITY.md lists the fix.)
    """
    out = []
    for si, name in enumerate(genome.names):
        seq = genome.scaffold(si)
        pieces = []
        cursor = 0
        for gi in np.nonzero(gaps["scaffold"] == si)[0]:
            if int(gi) not in fills:
                continue
            s = max(int(gaps["local_start"][gi]) - margin, cursor)
            e = min(int(gaps["local_end"][gi]) + margin, len(seq))
            pieces.append(seq[cursor:s])
            pieces.append(np.asarray(fills[int(gi)], np.int8))
            cursor = e
        pieces.append(seq[cursor:])
        out.append((name, np.concatenate(pieces) if len(pieces) > 1
                    else seq))
    return out


def fills_from_picked(ws, gaps) -> dict[int, np.ndarray]:
    """The full closures of picked_seqs.fa (extensions skipped) as
    {gap_index: fill codes}; the first record of a gap wins."""
    path = ws.path("picked_seqs.fa")
    fills = {}
    if not os.path.exists(path):
        return fills
    key = {(int(s), int(n)): i
           for i, (s, n) in enumerate(zip(gaps["scaffold"], gaps["number"]))}
    for name, codes in fasta.iter_fasta(path):
        parts = name.split("_")
        if parts[-1] == "extended":
            continue
        gi = key.get((int(parts[0]), int(parts[1])))
        if gi is not None and gi not in fills:
            fills[gi] = codes
    return fills


def run_patch(cfg, ws, genome: fasta.Genome | None = None) -> int:
    """The Patch stage on a workspace: the fills of picked_seqs.fa
    spliced into the draft, written to filled_scaffolds.fa. Returns the
    number of gaps filled."""
    from ..parallel import mp
    if genome is None:
        genome = fasta.read_fasta(cfg.draft_genome)
    gaps = ws.load_arrays("gaps")
    fills = fills_from_picked(ws, gaps)
    recs = patch_scaffolds(genome, gaps, fills, margin=cfg.flank_margin)
    if mp.is_primary():
        fasta.write_fasta(ws.path("filled_scaffolds.fa"), recs)
    return len(fills)
