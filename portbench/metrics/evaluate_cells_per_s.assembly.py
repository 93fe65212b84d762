"""Live cells a second of the Evaluate DP: the `cells` count (the sum
of n * m over the call's pairs) of a window unit's `assembly.evaluate`
span over the span's host seconds, the median over the units. None
where no unit's span counts cells (a program without the count)."""

import statistics


def read(ctx):
    spans = [u.get("stages", {}).get("assembly.evaluate", {})
             for u in ctx.units]
    rates = [s["cells"] / s["seconds"] for s in spans
             if s.get("cells") and s.get("seconds")]
    return statistics.median(rates) if rates else None
