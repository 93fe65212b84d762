"""Multi-process helpers (counterpart of gappadder_tpu/parallel/mp.py).

Only `is_primary` for now: host stages compute the same result on every
process, and files are written by the primary process alone. The rest
of the module (barriers, global gathers) comes with the multi-GPU port.
"""

from __future__ import annotations

import torch.distributed as tdist


def is_primary() -> bool:
    """Rank 0 of torch.distributed when it is initialised, else True."""
    if tdist.is_available() and tdist.is_initialized():
        return tdist.get_rank() == 0
    return True
