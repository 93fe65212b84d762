"""PyTorch/CUDA port of gappadder_tpu: the fused collect->assemble->pick
step, the Assembly batch and the Pick stage.

The package mirrors the JAX package's layout (`dna`, `config`, `io/`,
`ops/`, `pipeline/`, `parallel/`, `utils/`) so each module's
counterpart is easy to find. It imports torch and numpy only.
Hand-written CUDA kernels live in `csrc/` and are built with nvcc at
first use (see `ops/cuda_build.py`).
"""

import torch


def entry_device(device, entry: str) -> torch.device:
    """The device an entry point runs on: the card unless the caller
    asks for the CPU. Raises when a CUDA device is asked for and none is
    available, so nothing falls back to the CPU on its own."""
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"{entry}: no CUDA device is available; pass "
                           "device='cpu' to run on the CPU")
    return device
