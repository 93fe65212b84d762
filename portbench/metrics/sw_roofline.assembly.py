"""The SW kernel's share of its roofline over the traced unit (%): live
cells at 3 lane instructions a cell over the card's issue ceiling,
against the device time of every kernel launched inside the
`sw_batch_cuda` that `swutil` calls for every alignment of the
Assembly stage."""

from portbench.metrics._roofline import kernel_share


def read(ctx):
    return kernel_share(ctx, "sw")
