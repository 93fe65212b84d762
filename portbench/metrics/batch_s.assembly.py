"""Host seconds a window unit spends in the fused Assembly batches
(`assembly.batch`: read gather, k-mer count, DBG and cap growth, both
rounds), the median over the units."""

from portbench.metrics._unit_spans import median_seconds


def read(ctx):
    return median_seconds(ctx, ("assembly.batch",))
