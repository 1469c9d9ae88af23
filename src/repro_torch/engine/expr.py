"""A tiny scalar-expression IR evaluated column-at-a-time with torch.

Covers the expression surface of the paper's benchmarks (TPC-H Q1/Q6-style
arithmetic, range predicates, conjunctions): columns, constants, +,-,*,/,
comparisons, BETWEEN, AND/OR/NOT.
"""

from __future__ import annotations

import dataclasses
from typing import Tuple, Union

import torch

Number = Union[int, float]


class Expr:
    def __add__(self, other):
        return BinOp("+", self, _wrap(other))

    def __sub__(self, other):
        return BinOp("-", self, _wrap(other))

    def __mul__(self, other):
        return BinOp("*", self, _wrap(other))

    def __truediv__(self, other):
        return BinOp("/", self, _wrap(other))

    def __lt__(self, other):
        return Cmp("<", self, _wrap(other))

    def __le__(self, other):
        return Cmp("<=", self, _wrap(other))

    def __gt__(self, other):
        return Cmp(">", self, _wrap(other))

    def __ge__(self, other):
        return Cmp(">=", self, _wrap(other))

    def eq(self, other):
        return Cmp("==", self, _wrap(other))

    def ne(self, other):
        return Cmp("!=", self, _wrap(other))

    def between(self, lo, hi):
        return Between(self, float(lo), float(hi))

    def columns(self) -> Tuple[str, ...]:
        raise NotImplementedError


def _wrap(v) -> "Expr":
    if isinstance(v, Expr):
        return v
    return Const(float(v))


@dataclasses.dataclass(frozen=True)
class Col(Expr):
    name: str

    def columns(self):
        return (self.name,)


@dataclasses.dataclass(frozen=True)
class Const(Expr):
    value: float

    def columns(self):
        return ()


@dataclasses.dataclass(frozen=True)
class Param(Expr):
    """A hoisted constant: slot ``index`` of the runtime parameter vector.

    Produced by :func:`repro_torch.engine.logical.extract_constants`, which rewrites
    every :class:`Const` (and :class:`Between` bound) in a plan into a Param
    so the *template* plan is constant-free.  The physical layer keys its
    compile cache on templates and feeds the constants back in as a device
    operand at call time — one jitted executable serves every constant
    variant of a shape.  Evaluating a Param therefore requires ``params``
    (see :func:`eval_expr`); user-built plans never contain one.
    """

    index: int

    def columns(self):
        return ()


@dataclasses.dataclass(frozen=True)
class Str(Expr):
    """A string literal (dialect surface only).

    Tables are numeric; a Str is meaningful only while it compares against a
    dictionary-encoded column, and the session lowers it to the column's
    integer code (:func:`repro_torch.api.sql.resolve_string_literals`) before any
    plan reaches the engine.  Evaluating an unresolved Str is a type error —
    never a silent coercion.
    """

    value: str

    def columns(self):
        return ()


@dataclasses.dataclass(frozen=True)
class BinOp(Expr):
    op: str
    left: Expr
    right: Expr

    def columns(self):
        return tuple(dict.fromkeys(self.left.columns() + self.right.columns()))


@dataclasses.dataclass(frozen=True)
class Cmp(Expr):
    op: str
    left: Expr
    right: Expr

    def columns(self):
        return tuple(dict.fromkeys(self.left.columns() + self.right.columns()))


@dataclasses.dataclass(frozen=True)
class Between(Expr):
    """Two-sided range test.  ``lo``/``hi`` are floats in user plans; the
    constant-hoisting pass replaces them with :class:`Param` slots in
    template plans, so both spellings must evaluate."""

    arg: Expr
    lo: Union[float, Expr]
    hi: Union[float, Expr]

    def columns(self):
        return self.arg.columns()


@dataclasses.dataclass(frozen=True)
class And(Expr):
    left: Expr
    right: Expr

    def columns(self):
        return tuple(dict.fromkeys(self.left.columns() + self.right.columns()))


@dataclasses.dataclass(frozen=True)
class Or(Expr):
    left: Expr
    right: Expr

    def columns(self):
        return tuple(dict.fromkeys(self.left.columns() + self.right.columns()))


@dataclasses.dataclass(frozen=True)
class Not(Expr):
    arg: Expr

    def columns(self):
        return self.arg.columns()


def eval_expr(expr: Expr, columns, params=None) -> torch.Tensor:
    """Evaluate ``expr`` against a mapping name -> 1-D tensor.

    ``params`` is the runtime constant vector :class:`Param` slots index
    into; it is only needed for template plans (user plans carry their
    constants inline as :class:`Const` nodes).
    """
    if isinstance(expr, Col):
        return columns[expr.name]
    if isinstance(expr, Const):
        # a Python float is a weak scalar to torch: combined with an f32
        # or int32 column it computes in f32, never in f64
        return expr.value
    if isinstance(expr, Param):
        if params is None:
            raise TypeError(
                f"Param({expr.index}) outside a parametrized execution: "
                "template plans need the runtime constant vector")
        return params[expr.index]
    if isinstance(expr, Str):
        raise TypeError(
            f"unresolved string literal {expr.value!r}: string comparisons "
            "must be lowered to dictionary codes before execution (register "
            "a dictionary for the column on the Session)")
    if isinstance(expr, BinOp):
        l = eval_expr(expr.left, columns, params)
        r = eval_expr(expr.right, columns, params)
        if expr.op == "+":
            return l + r
        if expr.op == "-":
            return l - r
        if expr.op == "*":
            return l * r
        if expr.op == "/":
            return l / r
        raise ValueError(expr.op)
    if isinstance(expr, Cmp):
        l = eval_expr(expr.left, columns, params)
        r = eval_expr(expr.right, columns, params)
        if expr.op == "<":
            return l < r
        if expr.op == "<=":
            return l <= r
        if expr.op == ">":
            return l > r
        if expr.op == ">=":
            return l >= r
        if expr.op == "==":
            return l == r
        if expr.op == "!=":
            return l != r
        raise ValueError(expr.op)
    if isinstance(expr, Between):
        v = eval_expr(expr.arg, columns, params)
        lo = (eval_expr(expr.lo, columns, params)
              if isinstance(expr.lo, Expr) else expr.lo)
        hi = (eval_expr(expr.hi, columns, params)
              if isinstance(expr.hi, Expr) else expr.hi)
        return (v >= lo) & (v <= hi)
    if isinstance(expr, And):
        return (eval_expr(expr.left, columns, params)
                & eval_expr(expr.right, columns, params))
    if isinstance(expr, Or):
        return (eval_expr(expr.left, columns, params)
                | eval_expr(expr.right, columns, params))
    if isinstance(expr, Not):
        return ~eval_expr(expr.arg, columns, params)
    raise TypeError(f"not an Expr: {expr!r}")
