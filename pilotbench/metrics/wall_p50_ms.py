"""wall_p50_ms: the median of every query of the window, timed as
query_p50_ms times it.  A per-layer reading where the median is too
unsteady from run to run to be bounded end to end."""

import numpy as np


def read(ctx):
    walls = [r.wall_s for r in ctx.records if r.refresh is None]
    return float(np.median(walls)) * 1e3 if walls else None
