"""Typed fluent query builder — the programmatic twin of the SQL dialect.

    from repro_torch.api import sum_, avg_, count_
    from repro_torch.engine.expr import Col

    handle = (session.table("lineitem")
              .where(Col("l_quantity") < 24)
              .agg(sum_(Col("l_extendedprice") * Col("l_discount")).as_("rev"),
                   count_().as_("n"))
              .error(0.05, 0.95)
              .run())

Aggregate terms compose with Python arithmetic exactly along the paper's
Table-2 propagation rules: ``sum_(a) / sum_(b)`` is a ratio composite,
``sum_(a) * sum_(b)`` a product, ``0.5 * sum_(a) + 2 * sum_(b)`` a weighted
addition.  Everything lowers to the same frozen dataclasses
(:class:`repro_torch.core.taqa.Query` + :class:`CompositeAgg`) the SQL path
produces, so the two front doors are interchangeable.
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional, Tuple

from repro_torch.core.spec import CompositeAgg, ErrorSpec
from repro_torch.core.taqa import Query
from repro_torch.engine import logical as L
from repro_torch.engine.expr import And, Expr


@dataclasses.dataclass(frozen=True)
class Agg:
    """A (possibly composite) aggregate under construction."""

    kind: str
    expr: Optional[Expr] = None
    expr2: Optional[Expr] = None
    weights: Tuple[float, float] = (1.0, 1.0)
    name: Optional[str] = None
    _weight: float = 1.0  # pending scalar coefficient, consumed by '+'

    def as_(self, name: str) -> "Agg":
        return dataclasses.replace(self, name=name)

    # -- Table-2 composition rules ------------------------------------------
    def _require_sum(self, op: str) -> None:
        if self.kind != "sum":
            raise TypeError(f"{op} composites combine SUM terms only, "
                            f"got {self.kind}")
        if self._weight != 1.0:
            # refusing beats silently dropping the coefficient
            raise TypeError(f"scalar weights only apply to '+' composites; "
                            f"a {op} term cannot carry weight {self._weight}")

    def __truediv__(self, other: "Agg") -> "Agg":
        if not isinstance(other, Agg):
            raise TypeError(
                f"cannot divide an aggregate by {type(other).__name__}: "
                "Table-2 ratios are SUM/SUM (scale the inner expression "
                "instead, e.g. sum_(expr / 2))")
        self._require_sum("/")
        other._require_sum("/")
        return Agg("ratio", self.expr, other.expr,
                   name=self.name or other.name)

    def __mul__(self, other):
        if isinstance(other, Agg):
            self._require_sum("*")
            other._require_sum("*")
            return Agg("product", self.expr, other.expr,
                       name=self.name or other.name)
        return dataclasses.replace(self, _weight=self._weight * float(other))

    def __rmul__(self, other) -> "Agg":
        return self.__mul__(other)

    def __add__(self, other: "Agg") -> "Agg":
        if not isinstance(other, Agg):
            raise TypeError(
                f"cannot add {type(other).__name__} to an aggregate: "
                "Table-2 additions combine weighted SUM terms, e.g. "
                "sum_(a) + 2 * sum_(b)")
        for side in (self, other):
            if side.kind != "sum":
                raise TypeError(f"+ composites combine SUM terms only, "
                                f"got {side.kind}")
        return Agg("add", self.expr, other.expr,
                   weights=(self._weight, other._weight),
                   name=self.name or other.name)

    def to_composite(self, default_name: str) -> CompositeAgg:
        if self._weight != 1.0:
            raise TypeError("a scalar-weighted SUM term is only meaningful "
                            "inside an addition composite")
        return CompositeAgg(self.name or default_name, self.kind, self.expr,
                            expr2=self.expr2, weights=self.weights)


def sum_(expr: Expr) -> Agg:
    return Agg("sum", expr)


def count_() -> Agg:
    return Agg("count")


def avg_(expr: Expr) -> Agg:
    return Agg("avg", expr)


class QueryBuilder:
    """Fluent builder bound to a :class:`repro_torch.api.Session`.

    Each method returns ``self``; ``build()`` lowers to the internal
    representation, ``run()`` executes synchronously through the session and
    ``submit()`` enqueues on the session's scheduler.
    """

    def __init__(self, session, table: str):
        self._session = session
        self._table = table
        self._joins: List[Tuple[str, str, str]] = []
        self._preds: List[Expr] = []
        self._aggs: List[Agg] = []
        self._group_by: Optional[str] = None
        self._max_groups: Optional[int] = None
        self._spec: Optional[ErrorSpec] = None

    def join(self, table: str, left_key: str, right_key: str) -> "QueryBuilder":
        self._joins.append((table, left_key, right_key))
        return self

    def where(self, pred: Expr) -> "QueryBuilder":
        self._preds.append(pred)
        return self

    def agg(self, *aggs: Agg) -> "QueryBuilder":
        self._aggs.extend(aggs)
        return self

    def group_by(self, column: str,
                 max_groups: Optional[int] = None) -> "QueryBuilder":
        self._group_by = column
        self._max_groups = max_groups
        return self

    def error(self, error: Optional[float] = None,
              confidence: Optional[float] = None, **spec_kwargs) -> "QueryBuilder":
        """Attach an ERROR/CONFIDENCE target; defaults (and TAQA tunable
        overrides, ``SessionConfig.spec_kwargs``) come from the session
        config, exactly as for the SQL front door.  Explicit kwargs here win.
        Omitting this clause entirely means exact execution."""
        cfg = self._session.config
        kwargs = dict(cfg.spec_kwargs or {})
        kwargs.update(spec_kwargs)
        self._spec = ErrorSpec(
            error=cfg.default_error if error is None else error,
            confidence=(cfg.default_confidence if confidence is None
                        else confidence),
            **kwargs)
        return self

    def spec(self, spec: ErrorSpec) -> "QueryBuilder":
        self._spec = spec
        return self

    # -- lowering ------------------------------------------------------------
    def build(self) -> Tuple[Query, Optional[ErrorSpec]]:
        if not self._aggs:
            raise ValueError("no aggregates: call .agg(...) before build/run")
        child: L.Plan = L.Scan(self._table)
        for table, lk, rk in self._joins:
            child = L.Join(child, L.Scan(table), lk, rk)
        if self._preds:
            pred = self._preds[-1]
            for p in reversed(self._preds[:-1]):  # right fold, SQL-identical
                pred = And(p, pred)
            child = L.Filter(child, pred)
        max_groups = 1
        if self._group_by is not None:
            tables = (self._table,) + tuple(t for t, _, _ in self._joins)
            max_groups = (self._max_groups
                          if self._max_groups is not None
                          else self._session.infer_max_groups(
                              tables, self._group_by))
        q = Query(
            child=child,
            aggs=tuple(a.to_composite(f"agg{i}")
                       for i, a in enumerate(self._aggs)),
            group_by=self._group_by,
            max_groups=max_groups)
        return q, self._spec

    def run(self):
        q, spec = self.build()
        return self._session.execute(q, spec)

    def submit(self):
        q, spec = self.build()
        return self._session.submit_query(q, spec)
