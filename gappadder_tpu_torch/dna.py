"""DNA encoding primitives (numpy host side + torch device side).

    A=0  C=1  G=2  T=3  N(=any non-ACGT)=4  SEP=5 (scaffold separator)

``3 - code`` is the complement of A/C/G/T, so reverse-complement is a
flip plus an arithmetic complement.
"""

from __future__ import annotations

import numpy as np
import torch

A, C, G, T, N, SEP = 0, 1, 2, 3, 4, 5

# byte -> code lookup (case-insensitive; every non-ACGT byte maps to N)
_ENCODE_LUT = np.full(256, N, dtype=np.int8)
for _b, _c in ((b"Aa", A), (b"Cc", C), (b"Gg", G), (b"Tt", T)):
    _ENCODE_LUT[_b[0]] = _c
    _ENCODE_LUT[_b[1]] = _c

_DECODE_LUT = np.frombuffer(b"ACGTN.", dtype=np.uint8).copy()

# complement of codes 0..5 (N and SEP are their own complement)
COMPLEMENT = np.array([T, G, C, A, N, SEP], dtype=np.int8)


def encode(seq: bytes | str) -> np.ndarray:
    """Encode an ASCII sequence to int8 codes."""
    if isinstance(seq, str):
        seq = seq.encode("ascii")
    return _ENCODE_LUT[np.frombuffer(seq, dtype=np.uint8)]


def decode(codes: np.ndarray) -> str:
    """Decode int8 codes back to an ASCII string."""
    codes = np.asarray(codes)
    return _DECODE_LUT[np.clip(codes, 0, 5)].tobytes().decode("ascii")


def revcomp(codes: np.ndarray) -> np.ndarray:
    """Reverse-complement of an int8 code array (numpy)."""
    return COMPLEMENT[np.asarray(codes)[::-1]]


def revcomp_t(codes: torch.Tensor, length: torch.Tensor | None = None):
    """Reverse-complement of a code tensor along its last axis.

    With ``length`` the last axis is padded: the first ``length`` codes
    are reversed in place and the padding is filled with N.
    """
    comp = torch.where(codes < 4, (3 - codes).to(codes.dtype), codes)
    if length is None:
        return torch.flip(comp, dims=(-1,))
    n = codes.shape[-1]
    idx = (length.to(torch.int64)[..., None] - 1
           - torch.arange(n, device=codes.device))
    ok = idx >= 0
    idx = torch.where(ok, idx, torch.zeros_like(idx)).expand(comp.shape)
    got = torch.gather(comp, -1, idx)
    return torch.where(ok, got, torch.full_like(got, N))
