"""query_p50_ms: the median of every query of the window, each timed on the
host from the call of ``Session.sql`` to its answer on the host and the
card synchronized."""

import numpy as np


def read(ctx):
    walls = [r.wall_s for r in ctx.records if r.refresh is None]
    return float(np.median(walls)) * 1e3 if walls else None
