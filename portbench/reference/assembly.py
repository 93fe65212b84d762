"""The Assembly stage's picks judged against the planted truth, in plain
Python and numpy. Nothing here imports the program.

The configuration's guarantee: every closable gap filled with exactly
its planted bases, no open gap filled, extensions only of truth bases.
A pick is a record of picked_seqs.fa named after its gap, `<scaffold
index>_<gap number>_...` (the gap table's numbering, from 1 a
scaffold); a name ending in `_extended` is an extension, any other a
fill. Preprocess's flanks stop `flank_margin` bases short of a gap, so
a fill covers the truth over [start - margin, end + margin), and an
extension is `left + "NN" + right`, where `left` reads on from the left
flank's end (truth from start - margin) and `right` ends where the
right flank starts (truth up to end + margin). Where the left flank
aligns to the contig's reverse strand, GAPPadder's pick (pick_contigs.py,
kept by the program: `seq[:map_pos]`, 1-based) keeps the flank's last
base in `left`, so `left` may also start one base earlier, at
start - margin - 1.

Each side of an extension is a run of the truth at its place, read from
its flank outwards, and, where GAPPadder's merger has joined another
contig B onto the far end of the side's contig A, such as one
assembled from a chimeric pair's foreign read, one more piece: the rest
of B. The merger (ContigsMerger `-x 12 -s 0.4`, match +1, mismatch and
indel -2) joins B where its first MERGE_MIN_OVERLAP bases or more, all
of them aligned, end on A's last kept base at a score of at least
(1 - MERGE_SCORE_LOSS) of their length, and keeps A's bases over the
overlap. So a side reads: at least MIN_PIECE bases of the truth at its
place (or all of the side), then nothing, or one piece of at least
MIN_PIECE bases found on a strand of the truth where the bases before
it, read back from the piece, align so to the truth at the side's place
read back from the run's end. Any other base is off truth.

The traffic keeps every read off the middle 2 x OPEN_HOLE bases of an
open gap, so an open gap's extension can reach, on its left, the truth
up to mid - OPEN_HOLE and, on its right, from mid + OPEN_HOLE (mid the
gap's middle). How far short of that an extension stops, on its nearer
side, is its shortfall; a missing side falls short by its whole reach.
"""

from __future__ import annotations

import os

import numpy as np

from portbench.reference import chain

ACGTN = np.frombuffer(b"ACGTN", np.uint8)
COMPLEMENT = bytes.maketrans(b"ACGT", b"TGCA")
# the least length of a truth piece a side may hold: 20 random bases
# occur by chance in the two strands of 4.64 Mbp with p ~ 1e-5; the
# merger's contigs hold 40 bases or more (min_contig_len), so the rest
# of one past a chance overlap of 12 to 20 bases is longer
MIN_PIECE = 20
MERGE_MIN_OVERLAP = 12     # ContigsMerger -x
MERGE_SCORE_LOSS = 0.4     # ContigsMerger -s
OPEN_HOLE = 25             # genome_files: no read over mid +- 25
NUMBERS = ("fills_off", "closable_unfilled", "open_filled",
           "extensions_off_truth", "extension_shortfall")
MISSING = 1 << 30     # each number a missing picked_seqs.fa reads
# each number's limit: exact, but for the shortfall (PERF.md section 2)
LIMITS = dict(dict.fromkeys(NUMBERS, 0), extension_shortfall=30)


def read_fasta(path) -> list:
    """[(name, sequence bytes)] of a FASTA file, the name up to the
    first blank."""
    recs = []
    with open(path, "rb") as fh:
        for line in fh:
            line = line.rstrip(b"\r\n")
            if line.startswith(b">"):
                recs.append([line[1:].split()[0].decode() if line[1:].strip()
                             else "", []])
            elif recs:
                recs[-1][1].append(line)
    return [(name, b"".join(parts)) for name, parts in recs]


def write_fasta(path, records) -> None:
    """(name, sequence bytes) records, 80 bases a line."""
    with open(path, "wb") as fh:
        for name, seq in records:
            fh.write(b">" + name.encode() + b"\n")
            for i in range(0, max(len(seq), 1), 80):
                fh.write(seq[i:i + 80] + b"\n")


def gap_rows(sc: dict, min_gap_size: int) -> list:
    """The scenario's gaps as the gap table numbers them: one dict a
    gap, in genome order, with "id" (scaffold index, number), "scaffold",
    "start", "end" and "open". Raises where Preprocess's rules would
    find other gaps than the planted ones."""
    table = chain.gap_table(sc["draft_codes"], min_gap_size)
    planted = np.asarray(sc["gaps"], np.int64)
    found = np.stack([table["scaffold"], table["local_start"],
                      table["local_end"]], axis=1)
    if found.shape != planted.shape or not (found == planted).all():
        raise ValueError("the draft's gap table is not the planted gaps")
    opened = set(sc["open"])
    return [{"id": (int(s), int(n)), "scaffold": int(s), "start": int(a),
             "end": int(b), "open": g in opened}
            for g, (s, n, a, b) in enumerate(zip(
                table["scaffold"], table["number"], table["local_start"],
                table["local_end"]))]


def fill_truth(sc: dict, gap: dict, margin: int) -> bytes:
    """The truth a fill of `gap` covers: [start - margin, end + margin)."""
    truth = sc["scaffolds"][gap["scaffold"]]
    return ACGTN[truth[gap["start"] - margin:gap["end"] + margin]].tobytes()


def genome_strands(sc: dict) -> tuple:
    """The truth's scaffolds as one string a strand, "|" between them."""
    fwd = b"|".join(ACGTN[s].tobytes() for s in sc["scaffolds"])
    return fwd, fwd.translate(COMPLEMENT)[::-1]


def _common_prefix(a: bytes, b: bytes) -> int:
    n = min(len(a), len(b))
    x = np.frombuffer(a[:n], np.uint8) != np.frombuffer(b[:n], np.uint8)
    return int(x.argmax()) if x.any() else n


def merger_overlap(b_back: bytes, a_back: bytes) -> bool:
    """Whether the merger would join B onto A here: `b_back` is B's
    bases before the join and `a_back` A's kept bases, each read back
    from the join. Some overlap of pc >= MERGE_MIN_OVERLAP of B's bases,
    all aligned, with A's bases free at its far end, scores at least
    (1 - MERGE_SCORE_LOSS) * pc (match +1, mismatch and indel -2)."""
    n, m = len(a_back), len(b_back)
    if m < MERGE_MIN_OVERLAP:
        return False
    b = np.frombuffer(b_back, np.uint8)
    two_j = 2 * np.arange(m + 1)
    prev = -two_j                  # row 0: B's bases on indels
    best = prev.copy()
    for i in range(1, n + 1):
        # diagonal and up moves, then the left moves as a running max
        t = np.empty(m + 1, np.int64)
        t[0] = -2 * i
        t[1:] = np.maximum(prev[:-1] + np.where(b == a_back[i - 1], 1, -2),
                           prev[1:] - 2)
        prev = np.maximum.accumulate(t + two_j) - two_j
        best = np.maximum(best, prev)
    pc = np.arange(MERGE_MIN_OVERLAP, m + 1)
    return bool((best[pc] >= (1 - MERGE_SCORE_LOSS) * pc).any())


def _side(side: bytes, starts, truth, outwards: int, strands):
    """A side's run of the truth at its place: (bases of the run, the
    place it starts at, whether the side is on truth). `starts` are the
    places the side may start at, on the scaffold's codes `truth`, read
    from the flank outwards (`outwards` 1: rightwards from each start,
    -1: leftwards from each start, exclusive); `strands()` gives the
    truth's two strands."""
    out = side[::outwards]

    def at_place(a, w):
        seg = truth[a:a + w] if outwards == 1 else truth[max(a - w, 0):a]
        return ACGTN[seg].tobytes()[::outwards]
    run, start = max((_common_prefix(out, at_place(a, len(out))), a)
                     for a in starts)
    rest = out[run:]
    if not rest:
        return run, start, True
    if run < MIN_PIECE or len(rest) < MIN_PIECE:
        return run, start, False
    # the truth at the place read back from the run's end, into the flank
    end = start + outwards * run
    span = len(side) + MIN_PIECE
    a_back = (ACGTN[truth[max(end - span, 0):end]].tobytes()[::-1]
              if outwards == 1 else ACGTN[truth[end:end + span]].tobytes())
    for strand in strands():
        s = strand[::outwards]
        at = s.find(rest)
        while at >= 0:
            if merger_overlap(s[max(at - span, 0):at][::-1], a_back):
                return run, start, True
            at = s.find(rest, at + 1)
    return run, start, False


def extension_reach(sc: dict, gap: dict, margin: int, seq: bytes,
                    strands=None):
    """(whether an extension is `left + "NN" + right` with both sides on
    the truth beside the gap, the place its left run reaches up to, the
    place its right run reaches down to); the places are None where
    `seq` is not of that form. `strands` returns `genome_strands(sc)`,
    made only when a side needs it."""
    cut = seq.find(b"N")
    if cut < 0 or seq[cut:cut + 2] != b"NN" or b"N" in seq[cut + 2:]:
        return False, None, None
    left, right = seq[:cut], seq[cut + 2:]
    strands = strands or (lambda: genome_strands(sc))
    truth = sc["scaffolds"][gap["scaffold"]]
    lo = gap["start"] - margin
    hi = gap["end"] + margin
    lrun, lstart, lok = _side(left, (lo, lo - 1), truth, 1, strands)
    rrun, rstart, rok = _side(right, (hi,), truth, -1, strands)
    return lok and rok, lstart + lrun, rstart - rrun


def shortfall(gap: dict, margin: int, left_end=None, right_start=None):
    """The bases by which an open gap's extension, its left run reaching
    up to `left_end` and its right run down to `right_start`, falls
    short of the truth the reads reach, on its nearer side (GAPPadder's
    pick may keep one side: where both flanks hit one contig, the
    longer-matching); a missing side (None) falls short by its whole
    reach."""
    mid = (gap["start"] + gap["end"]) // 2
    left_end = gap["start"] - margin if left_end is None else left_end
    right_start = gap["end"] + margin if right_start is None \
        else right_start
    return max(min(mid - OPEN_HOLE - left_end,
                   right_start - mid - OPEN_HOLE), 0)


def judge_picked(path, sc: dict, params: dict) -> dict:
    """The numbers of NUMBERS for a picked_seqs.fa:

      fills_off             fills that are not their gap's truth over
                            [start - margin, end + margin), a second
                            fill of one gap, or a fill naming no gap
      closable_unfilled     gaps not open with no fill
      open_filled           open gaps with a fill
      extensions_off_truth  extensions not on the truth beside their
                            gap (see the module's docstring), or
                            naming no gap
      extension_shortfall   the most bases by which an open gap's
                            extension falls short of the truth its
                            reads reach, on its nearer side; a
                            missing extension by its nearer whole
                            reach
    """
    if not os.path.exists(path):
        return dict.fromkeys(NUMBERS, MISSING)
    margin = params["flank_margin"]
    gaps = gap_rows(sc, params["min_gap_size"])
    by_id = {g["id"]: g for g in gaps}
    out = dict.fromkeys(NUMBERS, 0)
    strands = []

    def genome():
        if not strands:
            strands.extend(genome_strands(sc))
        return strands
    filled = set()
    reach = {}
    for name, seq in read_fasta(path):
        parts = name.split("_")
        try:
            gap = by_id.get((int(parts[0]), int(parts[1])))
        except (ValueError, IndexError):
            gap = None
        if parts[-1] == "extended":
            ok, left_end, right_start = (False, None, None) if gap is None \
                else extension_reach(sc, gap, margin, seq, genome)
            out["extensions_off_truth"] += not ok
            if gap is not None and gap["id"] not in reach:
                reach[gap["id"]] = (left_end, right_start)
            continue
        if gap is None or gap["id"] in filled or \
                seq != fill_truth(sc, gap, margin):
            out["fills_off"] += 1
        if gap is not None:
            filled.add(gap["id"])
    for g in gaps:
        if g["open"]:
            out["open_filled"] += g["id"] in filled
            out["extension_shortfall"] = max(
                out["extension_shortfall"],
                shortfall(g, margin, *reach.get(g["id"], (None, None))))
        else:
            out["closable_unfilled"] += g["id"] not in filled
    return out


def truth_picks(sc: dict, params: dict, fill_open: bool = False) -> list:
    """The picks the guarantee asks for, as (name, bytes) records: each
    closable gap filled with its truth, each open gap extended with the
    truth its reads reach on both sides; with `fill_open`, the open
    gaps filled instead (the guarantee broken)."""
    margin = params["flank_margin"]
    picks = []
    for g in gap_rows(sc, params["min_gap_size"]):
        name = f"{g['id'][0]}_{g['id'][1]}_truth"
        if fill_open or not g["open"]:
            picks.append((name, fill_truth(sc, g, margin)))
            continue
        mid = (g["start"] + g["end"]) // 2
        truth = sc["scaffolds"][g["scaffold"]]
        picks.append((name + "_extended", ACGTN[np.r_[
            truth[g["start"] - margin:mid - OPEN_HOLE], 4, 4,
            truth[mid + OPEN_HOLE:g["end"] + margin]]].tobytes()))
    return picks
