"""pilot_ms: the median of ``TaqaReport.pilot_time_s`` (TAQA's first stage:
the pilot's block draw, its scan on the card and the host copy of its
per-block sums) over the window's approximate queries."""

from pilotbench.metrics import approximate, median_ms


def read(ctx):
    return median_ms([r.report["pilot_time_s"] for r in approximate(ctx)])
