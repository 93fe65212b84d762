"""Host seconds a window unit spends rescuing reads for the gaps still
open (`assembly.rescue`) and making their HQ pseudo-contigs
(`assembly.hq`), the median over the units."""

from portbench.metrics._unit_spans import median_seconds


def read(ctx):
    return median_seconds(ctx, ("assembly.rescue", "assembly.hq"))
