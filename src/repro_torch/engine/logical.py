"""Logical query plans.

PilotDB rewrites SQL; we rewrite these plans.  The supported surface mirrors
§2.3 of the paper: arbitrary compositions of Scan / Filter / equi-Join /
bag-Union under a terminal Aggregate with optional GROUP BY, with linear
aggregates (SUM / COUNT / AVG; AVG is planned as SUM/COUNT via the Table-2
propagation rules).  Non-linear aggregates (MIN/MAX/COUNT DISTINCT) are
rejected exactly as PilotDB rejects them.
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional, Tuple

from repro_torch.engine.expr import (And, Between, BinOp, Cmp, Const, Expr, Not, Or,
                               Param)

LINEAR_AGG_OPS = ("sum", "count", "avg")


@dataclasses.dataclass(frozen=True)
class SampleClause:
    """TABLESAMPLE SYSTEM (block) / BERNOULLI (row) analogue."""

    method: str  # "block" | "row"
    rate: float  # theta in (0, 1]
    seed: int = 0

    def __post_init__(self):
        if self.method not in ("block", "row"):
            raise ValueError(self.method)
        if not 0.0 < self.rate <= 1.0:
            raise ValueError(f"rate must be in (0,1], got {self.rate}")


@dataclasses.dataclass(frozen=True)
class AggSpec:
    op: str  # sum | count | avg
    expr: Optional[Expr]  # None for COUNT(*)
    name: str

    def __post_init__(self):
        if self.op not in LINEAR_AGG_OPS:
            raise ValueError(
                f"unsupported aggregate {self.op!r}: PilotDB supports linear aggregates only")


class Plan:
    def children(self) -> Tuple["Plan", ...]:
        return ()

    def scans(self) -> List["Scan"]:
        out = []
        if isinstance(self, Scan):
            out.append(self)
        for c in self.children():
            out.extend(c.scans())
        return out


@dataclasses.dataclass(frozen=True)
class Scan(Plan):
    table: str
    sample: Optional[SampleClause] = None


@dataclasses.dataclass(frozen=True)
class Filter(Plan):
    child: Plan
    pred: Expr

    def children(self):
        return (self.child,)


@dataclasses.dataclass(frozen=True)
class Join(Plan):
    """Equi-join; the right side's key must be unique among valid rows.

    The physical join preserves the left child's block structure, which is the
    concrete form of Prop. 4.5 (block sampling on the left input commutes with
    the join).
    """

    left: Plan
    right: Plan
    left_key: str
    right_key: str

    def children(self):
        return (self.left, self.right)


@dataclasses.dataclass(frozen=True)
class Union(Plan):
    """Bag union (UNION ALL) of same-schema children (Prop. 4.6)."""

    inputs: Tuple[Plan, ...]

    def children(self):
        return tuple(self.inputs)


@dataclasses.dataclass(frozen=True)
class Aggregate(Plan):
    child: Plan
    aggs: Tuple[AggSpec, ...]
    group_by: Optional[str] = None  # integer-coded group column
    max_groups: int = 1

    def children(self):
        return (self.child,)


def rewrite_scans(plan: Plan, samples: dict) -> Plan:
    """Return a copy of ``plan`` with Scan(table) nodes given sample clauses.

    ``samples`` maps table name -> SampleClause (or None to clear).  This is
    the plan-level analogue of §3.3's "add sampling clauses" rewriting step.
    """
    if isinstance(plan, Scan):
        if plan.table in samples:
            return dataclasses.replace(plan, sample=samples[plan.table])
        return plan
    if isinstance(plan, Filter):
        return dataclasses.replace(plan, child=rewrite_scans(plan.child, samples))
    if isinstance(plan, Join):
        return dataclasses.replace(
            plan,
            left=rewrite_scans(plan.left, samples),
            right=rewrite_scans(plan.right, samples),
        )
    if isinstance(plan, Union):
        return dataclasses.replace(
            plan, inputs=tuple(rewrite_scans(p, samples) for p in plan.inputs))
    if isinstance(plan, Aggregate):
        return dataclasses.replace(plan, child=rewrite_scans(plan.child, samples))
    raise TypeError(plan)


def strip_samples(plan: Plan) -> Plan:
    scans = plan.scans()
    return rewrite_scans(plan, {s.table: None for s in scans})


# ---------------------------------------------------------------------------
# Constant hoisting (template plans for the compile cache)
# ---------------------------------------------------------------------------

def _hoist_expr(e: Expr, out: List[float]) -> Expr:
    if isinstance(e, Const):
        out.append(float(e.value))
        return Param(len(out) - 1)
    if isinstance(e, Param):
        return e  # already a template
    if isinstance(e, BinOp):
        return BinOp(e.op, _hoist_expr(e.left, out), _hoist_expr(e.right, out))
    if isinstance(e, Cmp):
        return Cmp(e.op, _hoist_expr(e.left, out), _hoist_expr(e.right, out))
    if isinstance(e, Between):
        arg = _hoist_expr(e.arg, out)
        if isinstance(e.lo, Expr):
            lo: object = _hoist_expr(e.lo, out)
        else:
            out.append(float(e.lo))
            lo = Param(len(out) - 1)
        if isinstance(e.hi, Expr):
            hi: object = _hoist_expr(e.hi, out)
        else:
            out.append(float(e.hi))
            hi = Param(len(out) - 1)
        return Between(arg, lo, hi)
    if isinstance(e, And):
        return And(_hoist_expr(e.left, out), _hoist_expr(e.right, out))
    if isinstance(e, Or):
        return Or(_hoist_expr(e.left, out), _hoist_expr(e.right, out))
    if isinstance(e, Not):
        return Not(_hoist_expr(e.arg, out))
    return e  # Col, Str: no constants underneath


def _hoist_plan(p: Plan, out: List[float]) -> Plan:
    if isinstance(p, Scan):
        return p
    if isinstance(p, Filter):
        child = _hoist_plan(p.child, out)
        return Filter(child, _hoist_expr(p.pred, out))
    if isinstance(p, Join):
        return dataclasses.replace(p, left=_hoist_plan(p.left, out),
                                   right=_hoist_plan(p.right, out))
    if isinstance(p, Union):
        return Union(tuple(_hoist_plan(c, out) for c in p.inputs))
    if isinstance(p, Aggregate):
        child = _hoist_plan(p.child, out)
        aggs = tuple(
            a if a.expr is None
            else dataclasses.replace(a, expr=_hoist_expr(a.expr, out))
            for a in p.aggs)
        return dataclasses.replace(p, child=child, aggs=aggs)
    raise TypeError(p)


def extract_constants(plan: Plan) -> Tuple[Plan, Tuple[float, ...]]:
    """Split ``plan`` into a constant-free *template* and its constants.

    Every :class:`~repro_torch.engine.expr.Const` value (and ``Between`` bound) is
    replaced by a :class:`~repro_torch.engine.expr.Param` slot, in a fixed
    deterministic traversal order (children before predicates/aggregates,
    left to right), and collected into the returned tuple.  Two plans that
    differ only in predicate/expression constants therefore share one
    template with position-aligned constant vectors — the physical layer
    keys its compile cache on the template and feeds the constants in as a
    runtime operand, so a dashboard sweeping a date range reuses one
    executable instead of recompiling per constant.
    """
    out: List[float] = []
    template = _hoist_plan(plan, out)
    return template, tuple(out)
