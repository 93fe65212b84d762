"""The gap table Preprocess finds in a draft, in plain numpy: maximal
N-runs of at least min_gap_size bases with an ACGT after them in the
scaffold, numbered from 1 a scaffold. Nothing here imports the program.
"""

from __future__ import annotations

import numpy as np

N_CODE = 4


def gap_table(scaffolds, min_gap_size: int) -> dict:
    """The gaps of a draft given as int8 codes a scaffold: int64
    columns scaffold, number, local_start, local_end."""
    cols = {k: [] for k in ("scaffold", "number", "local_start",
                            "local_end")}
    for si, seq in enumerate(scaffolds):
        is_n = np.concatenate([[False], seq == N_CODE, [False]])
        edges = np.flatnonzero(is_n[1:] != is_n[:-1])
        starts, ends = edges[0::2], edges[1::2]
        keep = (ends - starts >= min_gap_size) & (ends < len(seq))
        for n, (s, e) in enumerate(zip(starts[keep], ends[keep]), 1):
            for k, v in zip(cols, (si, n, s, e)):
                cols[k].append(v)
    return {k: np.asarray(v, np.int64) for k, v in cols.items()}
