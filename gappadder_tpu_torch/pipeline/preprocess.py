"""The Preprocess stage's gap table (counterpart of
gappadder_tpu/pipeline/preprocess.py). Only the gap-id contract for now;
the gap scan and flank extraction come with the Preprocess stage.
"""

from __future__ import annotations

import numpy as np


def gap_ids(gaps: dict[str, np.ndarray]) -> list[str]:
    """Format the reference gap-id strings ("<scaffold>_<n>", n from 1)
    for a gap table."""
    return [f"{s}_{n}" for s, n in zip(gaps["scaffold"], gaps["number"])]
