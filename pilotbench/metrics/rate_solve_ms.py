"""rate_solve_ms: the median of ``TaqaReport.plan_time_s`` (the host's
bounds and sampling-rate solve between pilot and final) over the window's
approximate queries."""

from pilotbench.metrics import approximate, median_ms


def read(ctx):
    return median_ms([r.report["plan_time_s"] for r in approximate(ctx)])
