"""N-run (gap) detection and flank extraction (counterpart of
gappadder_tpu/ops/gapscan.py).

Semantics, the reference's:
  * a gap is a maximal run of non-ACGT codes (interior non-N ambiguity
    codes are swallowed into the gap);
  * a run with no ACGT after it in the same scaffold (trailing Ns) is
    dropped;
  * runs shorter than `min_gap_size` are dropped;
  * gap ids are "<scaffold_idx>_<n>" with n starting at 1 per scaffold;
  * left flank  = scaffold[max(0, start - flank_len) : start - margin],
    right flank = scaffold[end + margin : end + flank_len] (margin 5).

`find_gap_runs` and `extract_flanks` are the device forms, torch on the
tensors' device; `find_gap_runs_host` and `extract_flanks_host` are
their numpy twins, with the same outputs. `scan_genome` runs the device
form on the device asked for at every genome size; the gap numbering
per scaffold stays on the host.
"""

from __future__ import annotations

import numpy as np
import torch

from .. import dna, entry_device


def _first(mask, size: int):
    """Indices of the first `size` True entries of a 1-D mask, padded
    with -1 (jnp.nonzero with size and fill_value -1)."""
    idx = torch.nonzero(mask).reshape(-1)[:size]
    out = torch.full((size,), -1, dtype=torch.int64, device=mask.device)
    out[:idx.shape[0]] = idx
    return out


def find_gap_runs(seq, min_gap_size: int, max_gaps: int):
    """Qualifying N-runs of a concatenated genome of int8 codes [L]
    (SEP between scaffolds). Only the first `max_gaps` N-runs, short and
    trailing ones included, are looked at.

    Returns (starts, ends int32 [max_gaps], global coordinates with the
    end exclusive, the kept runs first and -1 after them; count int32
    scalar, the kept runs)."""
    L = seq.shape[0]
    dev = seq.device
    is_gap = seq == dna.N
    false = torch.zeros(1, dtype=torch.bool, device=dev)
    prev = torch.cat([false, is_gap[:-1]])
    nxt = torch.cat([is_gap[1:], false])
    start_mask = is_gap & ~prev
    end_mask = is_gap & ~nxt

    # trailing runs: does an ACGT follow within the same scaffold? A
    # running max from the right of (segment id * 2 + is_acgt), the
    # segment id counting SEPs from the right, keeps the flag inside
    # its segment
    rev_acgt = torch.flip(seq < dna.N, [0]).to(torch.int64)
    seg = torch.cumsum(torch.flip(seq == dna.SEP, [0]).to(torch.int64), 0)
    run = torch.cummax(seg * 2 + rev_acgt, 0).values
    acgt_follows = torch.flip(run - seg * 2, [0]) > 0

    starts_all = _first(start_mask, max_gaps)
    ends_all = _first(end_mask, max_gaps)
    valid = starts_all >= 0
    neg = torch.full_like(starts_all, -1)
    ends_excl = torch.where(valid, ends_all + 1, neg)
    length = torch.where(valid, ends_excl - starts_all,
                         torch.zeros_like(starts_all))
    keep = valid & (length >= min_gap_size) & \
        acgt_follows[starts_all.clamp(0, max(L - 1, 0))]

    # kept runs to the front, in order
    order = torch.argsort((~keep).to(torch.uint8), stable=True)
    starts = torch.where(keep[order], starts_all[order], neg[order])
    ends = torch.where(keep[order], ends_excl[order], neg[order])
    return (starts.to(torch.int32), ends.to(torch.int32),
            keep.sum().to(torch.int32))


def extract_flanks(seq, starts, ends, scaf_begin, scaf_end,
                   flank_len: int, margin: int = 5):
    """Fixed-width left and right flanks of a batch of gaps.

    seq: int8 [L]; starts, ends: [G] global gap coordinates (end
    exclusive, -1 pads); scaf_begin, scaf_end: [G] the global bounds of
    each gap's scaffold.

    Returns (left, right int8 [G, flank_len], both left-aligned and
    N-padded after their length: left[g, :left_len[g]] ends at
    start - margin, right[g, :right_len[g]] begins at end + margin;
    left_len, right_len int32 [G])."""
    starts, ends, scaf_begin, scaf_end = (
        x.to(torch.int64) for x in (starts, ends, scaf_begin, scaf_end))
    zero = torch.zeros_like(starts)
    pad = starts < 0
    l_end = torch.maximum(starts - margin, scaf_begin)         # exclusive
    l_begin = torch.maximum(starts - flank_len, scaf_begin)
    left_len = torch.where(pad, zero, torch.clamp(l_end - l_begin, min=0))
    r_begin = torch.minimum(ends + margin, scaf_end)
    r_end = torch.minimum(ends + flank_len, scaf_end)          # exclusive
    right_len = torch.where(pad, zero, torch.clamp(r_end - r_begin, min=0))

    offs = torch.arange(flank_len, device=seq.device)
    top = max(seq.shape[0] - 1, 0)
    nfill = torch.full((), dna.N, dtype=seq.dtype, device=seq.device)
    l_idx = (l_end - left_len)[:, None] + offs[None, :]
    l_ok = offs[None, :] < left_len[:, None]
    left = torch.where(l_ok, seq[l_idx.clamp(0, top)], nfill)
    r_idx = r_begin[:, None] + offs[None, :]
    r_ok = offs[None, :] < right_len[:, None]
    right = torch.where(r_ok, seq[r_idx.clamp(0, top)], nfill)
    return (left.to(torch.int8), right.to(torch.int8),
            left_len.to(torch.int32), right_len.to(torch.int32))


def find_gap_runs_host(seq: np.ndarray, min_gap_size: int):
    """Numpy twin of find_gap_runs over every run. Returns (starts,
    ends) int64 arrays of the kept runs in order."""
    is_gap = seq == dna.N
    d = is_gap[1:] != is_gap[:-1]
    edges = np.flatnonzero(d) + 1
    if not len(edges) and not (len(seq) and is_gap[0]):
        z = np.zeros(0, np.int64)
        return z, z
    starts = edges[1::2] if is_gap[0] else edges[0::2]
    ends = edges[0::2] if is_gap[0] else edges[1::2]
    if is_gap[0]:
        starts = np.concatenate([[0], starts])
    if is_gap[-1]:
        ends = np.concatenate([ends, [len(seq)]])
    # trailing-run rule: the code after a maximal run is never N and
    # codes are only {ACGT, N, SEP}, so "an ACGT follows within the
    # scaffold" is seq[end] being ACGT
    in_bounds = ends < len(seq)
    nxt = seq[np.minimum(ends, len(seq) - 1)]
    keep = (ends - starts >= min_gap_size) & in_bounds & (nxt < dna.N)
    return starts[keep].astype(np.int64), ends[keep].astype(np.int64)


def length_bucket(n: int) -> int:
    """A length padded up to {1, 1.5} * 2^k (at least 1024): the JAX
    package's shape buckets for its compiled scans, so that drafts of
    similar size share one shape, with at most 33 % padding."""
    if n <= 1024:
        return 1024
    p = 1 << (n - 1).bit_length()
    return (p * 3) // 4 if n <= (p * 3) // 4 else p


def extract_flanks_host(seq, starts, ends, scaf_begin, scaf_end,
                        flank_len: int, margin: int = 5):
    """Numpy twin of extract_flanks (same outputs)."""
    seq = np.asarray(seq)
    starts = np.asarray(starts, np.int64)
    ends = np.asarray(ends, np.int64)
    scaf_begin = np.asarray(scaf_begin, np.int64)
    scaf_end = np.asarray(scaf_end, np.int64)
    pad = starts < 0

    l_end = np.maximum(starts - margin, scaf_begin)
    l_begin = np.maximum(starts - flank_len, scaf_begin)
    left_len = np.where(pad, 0, np.maximum(l_end - l_begin, 0))
    r_begin = np.minimum(ends + margin, scaf_end)
    r_end = np.minimum(ends + flank_len, scaf_end)
    right_len = np.where(pad, 0, np.maximum(r_end - r_begin, 0))

    offs = np.arange(flank_len, dtype=np.int64)
    l_idx = l_end[:, None] - left_len[:, None] + offs[None, :]
    l_ok = offs[None, :] < left_len[:, None]
    left = np.where(l_ok, seq[np.clip(l_idx, 0, max(len(seq) - 1, 0))],
                    dna.N)
    r_idx = r_begin[:, None] + offs[None, :]
    r_ok = offs[None, :] < right_len[:, None]
    right = np.where(r_ok, seq[np.clip(r_idx, 0, max(len(seq) - 1, 0))],
                     dna.N)
    return (left.astype(np.int8), right.astype(np.int8),
            left_len.astype(np.int32), right_len.astype(np.int32))


def scan_genome(genome, min_gap_size: int, max_gaps: int | None = None,
                device="cuda"):
    """The gap table of a Genome: `find_gap_runs` on `device` (the card
    unless the caller asks for "cpu") over every N-run, then the first
    `max_gaps` kept runs (all without it) numbered per scaffold on the
    host. Returns int64 numpy columns start, end (global), scaffold,
    number (from 1 per scaffold), local_start, local_end; the same table
    as the JAX package's scan_genome_np."""
    device = entry_device(device, "scan_genome")
    seq = genome.seq
    if seq.shape[0] == 0:
        z = np.zeros(0, np.int64)
        return {"start": z, "end": z, "scaffold": z, "number": z,
                "local_start": z, "local_end": z}
    with torch.no_grad():
        seq_t = torch.from_numpy(np.ascontiguousarray(seq)).to(device)
        is_gap = seq_t == dna.N
        n_runs = int((is_gap[1:] & ~is_gap[:-1]).sum()) + int(is_gap[0])
        starts, ends, count = find_gap_runs(seq_t, min_gap_size,
                                            max(n_runs, 1))
        n = int(count)
        starts = starts[:n].cpu().numpy().astype(np.int64)
        ends = ends[:n].cpu().numpy().astype(np.int64)
    if max_gaps is not None:
        starts, ends = starts[:max_gaps], ends[:max_gaps]
        n = len(starts)
    scaf = genome.scaffold_index(starts)
    # per-scaffold counter starting at 1 (the reference's gap-id contract)
    counter = np.zeros(n, dtype=np.int64)
    seen: dict[int, int] = {}
    for i, s in enumerate(scaf):
        seen[s] = seen.get(s, 0) + 1
        counter[i] = seen[s]
    return {
        "start": starts,
        "end": ends,
        "scaffold": scaf.astype(np.int64),
        "number": counter,
        "local_start": starts - genome.offsets[scaf],
        "local_end": ends - genome.offsets[scaf],
    }
