"""Host seconds a window unit spends in Pick (`assembly.pick`: the
flank SW passes, tracebacks and selection, all three rounds), the
median over the units."""

from portbench.metrics._unit_spans import median_seconds


def read(ctx):
    return median_seconds(ctx, ("assembly.pick",))
