"""PyTorch/CUDA port of gappadder_tpu's fused collect->assemble->pick step.

The package mirrors the JAX package's layout (`dna`, `ops/`,
`pipeline/`, `parallel/`) so each module's counterpart is easy to find.
It imports torch and numpy only. Hand-written CUDA kernels live in
`csrc/` and are built with nvcc at first use (see `ops/sw_cuda.py`).
"""
