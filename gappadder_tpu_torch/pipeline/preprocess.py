"""Preprocess stage: gap positions and flank extraction (counterpart of
gappadder_tpu/pipeline/preprocess.py).

The whole concatenated draft is scanned for N-runs on the device
(`ops/gapscan.scan_genome`) and both flanks of every gap are gathered
there (`gapscan.extract_flanks`); the gap-id contract
("<scaffold_idx>_<n>", n from 1) is a table that every later stage
reads.

Outputs (in the workspace):
  gaps.npz      columns start/end (global), scaffold, number,
                local_start/local_end, the flanks and their lengths
  scaffold_names.json
  gap_positions.txt   the reference's text format
  flank_regions/<gap_id>.fa  (write_parity_files=True)
"""

from __future__ import annotations

import os

import numpy as np
import torch

from .. import entry_device
from ..config import Config
from ..io import fasta
from ..ops import gapscan
from .workspace import Workspace, config_hash


def gap_ids(gaps: dict[str, np.ndarray]) -> list[str]:
    """Format the reference gap-id strings ("<scaffold>_<n>", n from 1)
    for a gap table."""
    return [f"{s}_{n}" for s, n in zip(gaps["scaffold"], gaps["number"])]


def run_preprocess(cfg: Config, ws: Workspace | None = None,
                   genome: fasta.Genome | None = None,
                   write_parity_files: bool = False,
                   device="cuda") -> dict[str, np.ndarray]:
    """Scan the draft genome and extract the flanks on `device` (the card
    unless the caller asks for "cpu"); checkpoint the gap table into
    `ws`. Returns the table (numpy columns, as the JAX package's)."""
    device = entry_device(device, "run_preprocess")
    if genome is None:
        genome = fasta.read_fasta(cfg.draft_genome)
    gaps = gapscan.scan_genome(genome, cfg.min_gap_size, device=device)
    n = len(gaps["start"])

    scaf = gaps["scaffold"]
    scaf_begin = genome.offsets[scaf] if n else np.zeros(0, np.int64)
    scaf_end = (genome.offsets[scaf] + genome.lengths[scaf]) if n \
        else np.zeros(0, np.int64)

    def on(a):
        return torch.from_numpy(np.ascontiguousarray(a)).to(device)

    with torch.no_grad():
        left, right, left_len, right_len = (
            x.cpu().numpy() for x in gapscan.extract_flanks(
                on(genome.seq), on(gaps["start"]), on(gaps["end"]),
                on(scaf_begin), on(scaf_end), flank_len=cfg.flank_length,
                margin=cfg.flank_margin))

    table = dict(gaps)
    table["flank_left"] = left
    table["flank_right"] = right
    table["flank_left_len"] = left_len
    table["flank_right_len"] = right_len

    if ws is not None:
        from ..parallel import mp
        ws.save_arrays("gaps", **table)
        ws.save_json("scaffold_names", genome.names)
        if mp.is_primary():
            _write_gap_positions(ws.path("gap_positions.txt"), table,
                                 genome)
            if write_parity_files:
                _write_flank_fastas(ws.path("flank_regions"), table)
        ws.mark_done("preprocess", config_hash(cfg), num_gaps=int(n))
    return table


def _write_gap_positions(path: str, table, genome: fasta.Genome) -> None:
    """The reference's format: 'start end length scaffold_name' a line."""
    with open(path, "w") as fh:
        for s, e, scaf in zip(table["local_start"], table["local_end"],
                              table["scaffold"]):
            fh.write(f"{s} {e} {e - s} {genome.names[scaf]}\n")


def _write_flank_fastas(folder: str, table) -> None:
    """The reference's layout: flank_regions/<gap_id>.fa with the two
    records '<gap_id>_left' and '<gap_id>_right'."""
    os.makedirs(folder, exist_ok=True)
    ids = gap_ids(table)
    for i, gid in enumerate(ids):
        ll = int(table["flank_left_len"][i])
        rl = int(table["flank_right_len"][i])
        lseq = table["flank_left"][i][:ll]
        rseq = table["flank_right"][i][:rl]
        fasta.write_fasta(os.path.join(folder, f"{gid}.fa"),
                          [(f"{gid}_left", lseq), (f"{gid}_right", rseq)])
