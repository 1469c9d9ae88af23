"""draw_ms: the median over the window's approximate queries of the seconds
in the program's ``draw`` spans (the host's Bernoulli block draws of
``engine/sampling.py``), summed over each query's pilot and final."""

from pilotbench.metrics import approximate, median_ms
from pilotbench.spans import named, seconds


def read(ctx):
    return median_ms([seconds(r.spans, "draw") for r in approximate(ctx)
                      if named(r.spans, "draw")])
