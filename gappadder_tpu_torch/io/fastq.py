"""Columnar read store (counterpart of gappadder_tpu/io/fastq.py's
`ReadSet`). Scanning and parsing FASTQ files come with the Collect
stage of the port; the Assembly batch needs only the store.
"""

from __future__ import annotations

import dataclasses

import numpy as np


@dataclasses.dataclass
class ReadSet:
    """Columnar read store for one FASTQ file."""
    seq: np.ndarray          # int8 [N, Lmax], N-padded
    length: np.ndarray       # int32 [N]
    qual: np.ndarray         # uint8 [N, Lmax] (phred+33 raw bytes)
    name_hash: np.ndarray    # uint64 [N]
    names: list[bytes]       # kept for FASTQ re-emission

    @property
    def n(self) -> int:
        return len(self.length)

    def get_seq(self, row: int) -> np.ndarray:
        return self.seq[row, :self.length[row]]

    def get_qual(self, row: int) -> np.ndarray:
        return self.qual[row, :self.length[row]]

    def get_name(self, row: int) -> bytes:
        return self.names[row]
