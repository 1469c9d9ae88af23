"""The yardstick of the kernels' roofline shares: the chips' peaks and the
bytes a query's kernels need, counted from the query's own sizes.

Every count reads each input byte once and writes each output byte once,
whatever a kernel reads again, and never comes from a kernel's launch, so
it stays the same whatever implements the query later.
"""

from __future__ import annotations

from typing import Optional

from pilotbench import tables

# Published peaks (data sheets; SXM parts, dense, at the full power limit).
PEAKS = {
    "NVIDIA H100 80GB HBM3": {"hbm_bytes_per_s": 3.35e12},
}


def hbm_bytes_per_s(device_kind: str) -> Optional[float]:
    peak = PEAKS.get(device_kind)
    return None if peak is None else peak["hbm_bytes_per_s"]


def row_bytes(config: dict, table: str, columns) -> int:
    """Bytes of one row of the given stored columns."""
    return sum(tables.column_bytes(config, table, c) for c in columns)


def segment_sum_bytes(rows: int, value_channels: int, groups: int,
                      channels: int) -> int:
    """A segmented sum of ``rows`` rows: one f32 value a value channel and
    one int32 segment key a row in, one f32 sum a channel and group out
    (a count channel needs no input)."""
    return rows * (4 * value_channels + 4) + 4 * channels * groups
