"""host_read_ms: the median over the window's single queries of the seconds
in their ``host_read`` spans, summed: the host's waits for the work queued
before each read, and the copies."""

from pilotbench.metrics import median_ms, single
from pilotbench.spans import named, seconds


def read(ctx):
    return median_ms([seconds(r.spans, "host_read") for r in single(ctx)
                      if named(r.spans, "host_read")])
