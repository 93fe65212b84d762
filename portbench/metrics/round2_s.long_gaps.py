"""Host seconds a window unit spends rescuing reads for the gaps round 1
left open and assembling, refining and picking those gaps again
(`assembly.round2`), the median over the units."""

from portbench.metrics._unit_spans import median_seconds


def read(ctx):
    return median_seconds(ctx, ("assembly.round2",))
