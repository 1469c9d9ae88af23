"""advisory_ms: the median over the window's approximate queries of the
seconds in the program's ``advisory`` span: the provisional estimate the
session makes from the pilot's block sums (``core/taqa.py``
``advisory_estimate``), between the pilot and the rate solve."""

from pilotbench.metrics import approximate, median_ms
from pilotbench.spans import named, seconds


def read(ctx):
    return median_ms([seconds(r.spans, "advisory") for r in approximate(ctx)
                      if named(r.spans, "advisory")])
