"""The sort kernel's share of its roofline over the traced unit (%):
each plane read and written once at its dtype's size over HBM
bandwidth, against the device time of every kernel launched inside
`psort.bitonic_sort`."""

from portbench.metrics._roofline import kernel_share


def read(ctx):
    return kernel_share(ctx, "sort")
