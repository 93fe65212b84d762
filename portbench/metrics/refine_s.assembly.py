"""Host seconds a window unit spends refining contigs
(`assembly.refine`: dedup SW screens, the overlap merge and the
Evaluate DP, `assembly.evaluate`, which it holds), the median over the
units."""

from portbench.metrics._unit_spans import median_seconds


def read(ctx):
    return median_seconds(ctx, ("assembly.refine",))
