"""Readings of the program's own spans in each window unit's
metrics.json (the entry keeps its "stages" a unit)."""

from __future__ import annotations

import statistics


def median_seconds(ctx, names):
    """The median over the window units of the summed host seconds of
    the spans `names` in a unit (a span a unit did not open counts 0);
    None where no unit opened any of them."""
    units = [u.get("stages", {}) for u in ctx.units]
    if not any(n in st for st in units for n in names):
        return None
    return statistics.median(
        sum(st.get(n, {}).get("seconds", 0.0) for n in names)
        for st in units)
