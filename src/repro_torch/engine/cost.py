"""Bytes-moved cost model (§3.2 "Cost-based Optimization").

PilotDB asks the DBMS's cost estimator for plan costs; for in-memory engines
(DuckDB) the paper falls back to "volume of scanned data".  We are the storage
engine, so we use the same proxy: device-memory bytes a plan will move.

* exact / row-sampled scan: all referenced column bytes stream;
* block-sampled scan at rate θ: only ≈θ of the slabs move (expected bytes);
* joins/aggregations add a small per-row processing term so that plans which
  keep more rows alive cost more (matters when comparing candidate plans that
  sample different tables).
"""

from __future__ import annotations

from typing import Dict, Optional

from repro_torch.engine import logical as L
from repro_torch.engine.table import BlockTable

PROCESS_BYTES_PER_ROW = 4  # processing term, bytes-equivalent per surviving row


def _referenced_columns(plan: L.Plan, acc: Dict[str, set]):
    if isinstance(plan, L.Scan):
        acc.setdefault(plan.table, set())
    elif isinstance(plan, L.Filter):
        _referenced_columns(plan.child, acc)
        for c in plan.pred.columns():
            for t in acc:
                acc[t].add(c)
    elif isinstance(plan, L.Join):
        _referenced_columns(plan.left, acc)
        _referenced_columns(plan.right, acc)
        for t in acc:
            acc[t].update((plan.left_key, plan.right_key))
    elif isinstance(plan, L.Union):
        for p in plan.inputs:
            _referenced_columns(p, acc)
    elif isinstance(plan, L.Aggregate):
        _referenced_columns(plan.child, acc)
        for a in plan.aggs:
            if a.expr is not None:
                for c in a.expr.columns():
                    for t in acc:
                        acc[t].add(c)
        if plan.group_by:
            for t in acc:
                acc[t].add(plan.group_by)


def column_bytes(table: BlockTable, columns: Optional[set] = None) -> int:
    total = 0
    for name, col in table.columns.items():
        if columns is None or name in columns or not columns:
            total += int(col.element_size()) * table.padded_rows
    return total


def plan_cost(plan: L.Aggregate, catalog: Dict[str, BlockTable],
              rates: Optional[Dict[str, float]] = None) -> float:
    """Estimated cost (bytes) of executing ``plan`` with optional per-table
    block sampling rates overriding the plan's own sample clauses."""
    rates = dict(rates or {})
    acc: Dict[str, set] = {}
    _referenced_columns(plan, acc)

    cost = 0.0
    for scan in plan.scans():
        t = catalog[scan.table]
        cols = acc.get(scan.table)
        base = column_bytes(t, cols if cols else None)
        theta = rates.get(scan.table)
        if theta is None and scan.sample is not None:
            theta = scan.sample.rate if scan.sample.method == "block" else 1.0
        theta = 1.0 if theta is None else min(max(theta, 0.0), 1.0)
        cost += theta * base + theta * t.num_rows * PROCESS_BYTES_PER_ROW
    return cost


def exact_cost(plan: L.Aggregate, catalog: Dict[str, BlockTable]) -> float:
    return plan_cost(L.strip_samples(plan), catalog, rates={})
