"""ppf_calls_per_query: the median over the window's approximate queries of
``TaqaReport.ppf_calls``, the percentile evaluations (normal, Student's t,
chi-squared) of the query's rate solve."""

import numpy as np

from pilotbench.metrics import approximate


def read(ctx):
    v = [r.report["ppf_calls"] for r in approximate(ctx) if "ppf_calls" in r.report]
    return float(np.median(v)) if v else None
