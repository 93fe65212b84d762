"""Both-unmapped reads a second that rescue matches against the round-1
contigs of the gaps still open: the `reads` count of a window unit's
`assembly.rescue` span over the span's host seconds, the median over
the units. None where no unit's span counts reads (a program without
the count)."""

import statistics


def read(ctx):
    spans = [u.get("stages", {}).get("assembly.rescue", {})
             for u in ctx.units]
    rates = [s["reads"] / s["seconds"] for s in spans
             if s.get("reads") and s.get("seconds")]
    return statistics.median(rates) if rates else None
