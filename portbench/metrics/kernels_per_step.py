"""CUDA kernels the traced steps ran, a step: the host's issue load."""


def read(ctx):
    tr = ctx.trace
    if tr is None or not ctx.traced_units or not tr.kernels:
        return None
    return tr.kernels / ctx.traced_units
