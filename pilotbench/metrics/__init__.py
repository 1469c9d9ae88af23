"""The metric readers, one file a metric, named as in ``BENCHMARK.json``
(``<metric>.py``, loaded by path), each a ``read(ctx)`` that returns the
number, or None where the run holds nothing for it to read.  ``ctx`` is the
run as :func:`pilotbench.harness.run_cell` builds it.  This module holds
what several readers share."""

import numpy as np

from pilotbench import reference, roofline


def single(ctx):
    """The window's records of single queries (sql mode)."""
    return [r for r in ctx.records if r.refresh is None and r.report]


def approximate(ctx):
    """Single queries with an ERROR clause whose pilot ran."""
    return [r for r in single(ctx) if r.query.guarantee is not None
            and r.report.get("pilot_ran")]


def median_ms(values):
    return float(np.median(values)) * 1e3 if values else None


def idle_pct(ctx):
    t = ctx.trace
    if t is None or not t.window_s:
        return None
    return 100.0 * (1.0 - t.busy_s / t.window_s)


def kernel_seconds(ctx, match) -> float:
    """Device seconds of the traced window's kernels whose unqualified name
    ``match`` accepts."""
    from pilotbench.trace import base_name
    return sum(o.dur_s for o in ctx.trace.ops
               if o.cat == "kernel" and match(base_name(o.name)))


def roofline_pct(ctx, needed_bytes: float, seconds: float):
    """The share of the memory roofline: the least time ``needed_bytes``
    take at the chip's peak bandwidth over the kernels' device time."""
    peak = roofline.hbm_bytes_per_s(ctx.device_kind)
    if peak is None or seconds <= 0 or needed_bytes <= 0:
        return None
    return 100.0 * needed_bytes / peak / seconds


def family(r):
    return reference.family(r.query.family)
