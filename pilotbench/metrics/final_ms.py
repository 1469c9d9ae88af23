"""final_ms: the median of ``TaqaReport.final_time_s`` (TAQA's second
stage: the final's block draw, its scan on the card and the upscale) over
the window's approximate queries."""

from pilotbench.metrics import approximate, median_ms


def read(ctx):
    return median_ms([r.report["final_time_s"] for r in approximate(ctx)])
