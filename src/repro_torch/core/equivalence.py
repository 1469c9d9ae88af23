"""Sampling-equivalence rules (§4.2, Props. 4.4–4.6).

Block sampling commutes with selection, join (on the non-sampled side's
uniqueness pattern), bag union, projection, and group-by.  The physical
operators (:mod:`repro_torch.engine.ops`) realize the commutativity
*pathwise*: conditioning on the kept block set S, `op(gather(T, S))` and
`gather(op-preserving-layout(T), S)` produce identical surviving multisets.
Pathwise equality under a shared coupling implies Definition 4.2's
distributional equality (and hence Prop. 4.3: identical aggregate
distributions) — this module exposes both sides of each rule so tests can
verify equality exhaustively.

`normalize` implements Eq. 8: push every sample clause to its base-table
scan, yielding the standard form AGG(⋈ᵢ B_θᵢ(T̃ᵢ)) that BSAP's statistics
assume.  The logical IR only *carries* samples on scans, so normalization
amounts to validation plus the pre/post execution pair used in tests.
"""

from __future__ import annotations

from typing import Dict

import numpy as np

from repro_torch.engine import logical as L
from repro_torch.engine import ops
from repro_torch.engine.expr import Expr
from repro_torch.engine.table import BlockTable


def sample_then_filter(table: BlockTable, keep_blocks: np.ndarray, pred: Expr) -> BlockTable:
    return ops.filter_table(table.gather_blocks(keep_blocks), pred)


def filter_then_sample(table: BlockTable, keep_blocks: np.ndarray, pred: Expr) -> BlockTable:
    return ops.filter_table(table, pred).gather_blocks(keep_blocks)


def sample_then_join(left: BlockTable, keep_blocks: np.ndarray, right: BlockTable,
                     lk: str, rk: str) -> BlockTable:
    return ops.join_unique(left.gather_blocks(keep_blocks), right, lk, rk)


def join_then_sample(left: BlockTable, keep_blocks: np.ndarray, right: BlockTable,
                     lk: str, rk: str) -> BlockTable:
    return ops.join_unique(left, right, lk, rk).gather_blocks(keep_blocks)


def sample_then_union(tables, keeps) -> BlockTable:
    return ops.union_all([t.gather_blocks(k) for t, k in zip(tables, keeps)])


def union_then_sample(tables, keeps) -> BlockTable:
    u = ops.union_all(list(tables))
    offs, out = 0, []
    for t, k in zip(tables, keeps):
        out.append(np.asarray(k) + offs)
        offs += t.num_origin_blocks
    return u.gather_blocks(np.concatenate(out) if out else np.zeros(0, np.int32))


def surviving_columns(table: BlockTable) -> Dict[str, np.ndarray]:
    """Each column's values on the valid rows, on the host."""
    mask = table.valid.cpu().numpy()
    return {c: v.cpu().numpy()[mask] for c, v in table.columns.items()}


def surviving_rows(table: BlockTable, columns=None) -> dict:
    """Canonical multiset of surviving rows for equality checks."""
    data = surviving_columns(table)
    cols = sorted(columns or data.keys())
    rows = np.stack([np.asarray(data[c], dtype=np.float64) for c in cols], axis=-1)
    order = np.lexsort(rows.T[::-1]) if len(rows) else np.zeros(0, np.int64)
    return {"cols": cols, "rows": rows[order]}


def normalize(plan: L.Plan) -> L.Plan:
    """Eq. 8 standard form: verify all sampling sits on base-table scans.

    Raises if a sample clause is attached anywhere else (the IR cannot even
    express that — this is the middleware invariant TAQA relies on)."""
    for scan in plan.scans():
        if scan.sample is not None and scan.sample.method not in ("block", "row"):
            raise ValueError(f"unknown sampling method {scan.sample.method}")
    return plan
