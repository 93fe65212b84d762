"""Batched lexicographic sort over 1-4 key planes plus payloads.

Counterpart of gappadder_tpu/ops/psort.py::bitonic_sort. The JAX
package's default path runs `lax.sort` there (its Pallas bitonic kernel
`_bitonic_call` is opt-in); this module is the counterpart of that
default: an LSD chain of stable `torch.sort` passes over the key
planes, last key first. The hand-written Hopper sort that replaces
`_bitonic_call` belongs to the next slice of the port (its rows of
38k-65k elements with up to 4 key planes do not fit one CTA's shared
memory and need a design of their own).

Keys and payloads are int64 tensors holding uint32 or int32 values
(k-mer limbs are stored as int64, see ops/kmers.py), so int32 keys
order as signed and uint32 keys as unsigned with no bit mapping.
"""

from __future__ import annotations

import torch


def bitonic_sort(ops, num_keys: int, stable: bool = False):
    """Sort a tuple of [..., N] tensors ascending along the last axis,
    lexicographically by the first `num_keys` of them; the rest ride
    along. Returns a tuple in the same order.

    The LSD chain of stable passes is stable, so `stable=True` (equal
    keys keep their input order, like `lax.sort(is_stable=True)`) costs
    nothing extra; the flag is kept for the JAX signature.
    """
    del stable
    ops = tuple(ops)
    assert 1 <= num_keys <= len(ops)
    perm = None
    for l in range(num_keys - 1, -1, -1):
        key = ops[l] if perm is None else torch.gather(ops[l], -1, perm)
        _, idx = torch.sort(key, dim=-1, stable=True)
        perm = idx if perm is None else torch.gather(perm, -1, idx)
    return tuple(torch.gather(o, -1, perm) for o in ops)
