"""Host seconds a window unit spends on the gaps rounds 1 and 2 left
open: HQ pseudo-contigs, their re-merge and the relaxed pick with its
extensions (`assembly.final`), the median over the units."""

from portbench.metrics._unit_spans import median_seconds


def read(ctx):
    return median_seconds(ctx, ("assembly.final",))
