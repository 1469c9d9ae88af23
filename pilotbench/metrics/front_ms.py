"""front_ms: the median, over the window's queries, of the host wall less
the TAQA stages the program timed itself (pilot + rate solve + final):
parsing, lowering, seed derivation, the session's bookkeeping and the
delivery."""

import numpy as np


def read(ctx):
    v = [r.wall_s - (r.report["pilot_time_s"] + r.report["plan_time_s"]
                     + r.report["final_time_s"])
         for r in ctx.records if r.refresh is None and r.report]
    return float(np.median(v)) * 1e3 if v else None
