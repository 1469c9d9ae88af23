"""query_p95_ms: the 95th percentile (linear between order statistics) of
the same walls as query_p50_ms."""

import numpy as np


def read(ctx):
    walls = [r.wall_s for r in ctx.records if r.refresh is None]
    return float(np.percentile(walls, 95)) * 1e3 if walls else None
