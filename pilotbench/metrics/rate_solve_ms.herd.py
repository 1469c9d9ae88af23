"""rate_solve_ms.herd: the median over the window's refreshes of the rate
solves' host seconds (``TaqaReport.plan_time_s``) summed over a refresh and
divided by its queries."""

import numpy as np


def read(ctx):
    per = {}
    for r in ctx.records:
        if r.refresh is not None and r.report:
            per.setdefault(r.refresh, []).append(r.report["plan_time_s"])
    v = [sum(x) / len(x) for x in per.values()]
    return float(np.median(v)) * 1e3 if v else None
