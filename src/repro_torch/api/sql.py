"""The PilotDB SQL dialect (§2.4): parser and renderer.

Grammar (case-insensitive keywords)::

    query   := SELECT item (',' item)*
               FROM ident (JOIN ident ON column '=' column)*
               (WHERE pred)?
               (GROUP BY column (MAXGROUPS int)?)?
               (HAVING ident cmp num)?
               ((ORDER BY ident (ASC|DESC)?)? LIMIT int)?
               (ERROR num '%' CONFIDENCE num '%')?
    item    := composite (AS ident)?
    composite := wterm '+' wterm          -- addition rule (Table 2)
               | aggcall '/' aggcall      -- division rule: SUM/SUM ratio
               | aggcall '*' aggcall      -- multiplication rule
               | aggcall
    wterm   := (num '*')? aggcall         -- weighted SUM, only under '+'
    aggcall := SUM '(' expr ')' | AVG '(' expr ')' | COUNT '(' '*' ')'
    pred    := or-chain of AND-chains of comparisons / BETWEEN / NOT (...)
    expr    := arithmetic over columns and numeric literals (+ - * /)
    column  := ident | ident '.' ident    -- optional table qualifier
    string  := "'" chars "'"              -- '' escapes a quote; strings may
                                          -- appear as comparison operands

`MAXGROUPS n` is a dialect extension fixing the group-id domain
(``Query.max_groups``); when omitted the caller may supply a resolver that
infers it from catalog statistics (see :meth:`repro_torch.api.Session.sql`).

Column names are globally unique in this schema family (TPC-H style), so a
``t.col`` qualifier is presentation sugar: the parser strips it, and
:func:`render_sql` emits the canonical unqualified form.  String literals
parse to :class:`repro_torch.engine.expr.Str` nodes, which
:func:`resolve_string_literals` lowers to dictionary codes before a plan
reaches the engine (sessions call it with their registered dictionaries).

Lowering targets the existing internal representation unchanged:
:class:`repro_torch.core.taqa.Query` (+ :class:`repro_torch.core.spec.ErrorSpec`), i.e.
the same frozen dataclasses tests hand-build.  AND/OR chains fold *right*
(``a AND b AND c`` -> ``And(a, And(b, c))``) and arithmetic folds left,
matching the hand-built idiom, so parse -> lower reproduces those plans
bit-for-bit and :func:`render_sql` round-trips through :func:`parse_sql`.
"""

from __future__ import annotations

import dataclasses
import re
from typing import Callable, List, Optional, Tuple

from repro_torch.core.spec import CompositeAgg, ErrorSpec
from repro_torch.core.taqa import Query
from repro_torch.engine import logical as L
from repro_torch.engine.expr import (And, Between, BinOp, Cmp, Col, Const, Expr, Not,
                               Or, Str)


class SqlSyntaxError(ValueError):
    """The query text does not parse in the PilotDB dialect."""


class UnsupportedSqlError(ValueError):
    """A plan/query outside the dialect surface (rendering direction)."""


@dataclasses.dataclass(frozen=True)
class HavingClause:
    """``HAVING <agg> <cmp> <number>``: a post-aggregation filter.

    The comparison references an output aggregate by its SELECT alias and
    is applied AFTER the approximate aggregation, to the returned groups of
    an :class:`repro_torch.core.taqa.ApproxAnswer` (or one rebuilt from a cached
    record): groups whose estimated value fails the comparison are cleared
    from ``group_present``.  It never reaches the engine plan — the plan
    signature, pilot sharing, seeds, and the result-cache key are all
    HAVING-agnostic, so HAVING-varied re-issues of one query share the same
    pilot, compilation, and cached base answer.
    """

    agg: str
    op: str       # normalized: == != < <= > >=
    value: float

    def apply(self, answer):
        """A copy of ``answer`` with failing groups cleared (the values
        array is untouched — HAVING filters group membership, not
        estimates).  NaN estimates (absent groups) never pass."""
        import numpy as np
        if self.agg not in answer.names:
            raise UnsupportedSqlError(
                f"HAVING references unknown aggregate {self.agg!r} "
                f"(outputs: {answer.names})")
        vals = np.asarray(answer.values[answer.names.index(self.agg)])
        with np.errstate(invalid="ignore"):
            ok = _HAVING_OPS[self.op](vals, self.value)
        present = np.asarray(answer.group_present, dtype=bool) & ok
        return dataclasses.replace(answer, group_present=present)


_HAVING_OPS = {
    "==": lambda v, c: v == c,
    "!=": lambda v, c: v != c,
    "<": lambda v, c: v < c,
    "<=": lambda v, c: v <= c,
    ">": lambda v, c: v > c,
    ">=": lambda v, c: v >= c,
}


@dataclasses.dataclass(frozen=True)
class LimitClause:
    """``[ORDER BY <agg> [ASC|DESC]] LIMIT n``: post-aggregation top-n.

    Same contract as :class:`HavingClause` (and applied after it): the
    selection acts on the delivered answer's present groups — ranked by the
    named output aggregate's estimates when ORDER BY is given, by group id
    otherwise — and never reaches the engine plan.  Signatures, pilot
    sharing, seeds, and the result-cache key are all LIMIT-agnostic, so
    LIMIT-varied re-issues of one query share the same pilot, compilation,
    and cached base answer.  ORDER BY without LIMIT is rejected at parse:
    answers are unordered group sets, so ordering only exists to select.
    """

    n: int
    order_by: Optional[str] = None
    desc: bool = False

    def apply(self, answer):
        """A copy of ``answer`` keeping at most ``n`` present groups (the
        values array is untouched — LIMIT selects group membership, not
        estimates).  Ties and NaN-last ranking follow numpy stable argsort,
        so repeated applications are deterministic."""
        import numpy as np
        present = np.asarray(answer.group_present, dtype=bool)
        idx = np.nonzero(present)[0]
        if len(idx) <= self.n:
            return dataclasses.replace(answer, group_present=present)
        if self.order_by is not None:
            if self.order_by not in answer.names:
                raise UnsupportedSqlError(
                    f"ORDER BY references unknown aggregate "
                    f"{self.order_by!r} (outputs: {answer.names})")
            vals = np.asarray(
                answer.values[answer.names.index(self.order_by)])[idx]
            key = -vals if self.desc else vals
            keep = idx[np.argsort(key, kind="stable")[:self.n]]
        else:
            keep = idx[:self.n]
        new_present = np.zeros_like(present)
        new_present[keep] = True
        return dataclasses.replace(answer, group_present=new_present)


@dataclasses.dataclass(frozen=True)
class ParsedQuery:
    query: Query
    spec: Optional[ErrorSpec]   # None: no ERROR clause -> exact execution
    having: Optional[HavingClause] = None
    limit: Optional[LimitClause] = None

    @property
    def is_approximate(self) -> bool:
        return self.spec is not None


# ---------------------------------------------------------------------------
# Tokenizer
# ---------------------------------------------------------------------------

_KEYWORDS = {
    "SELECT", "FROM", "WHERE", "GROUP", "BY", "JOIN", "ON", "AS", "AND",
    "OR", "NOT", "BETWEEN", "SUM", "COUNT", "AVG", "ERROR", "CONFIDENCE",
    "MAXGROUPS", "HAVING", "ORDER", "LIMIT", "ASC", "DESC",
}

_TOKEN_RE = re.compile(
    r"\s*(?:"
    r"(?P<num>\d+(?:\.\d+)?(?:[eE][+-]?\d+)?)"
    r"|(?P<str>'(?:[^']|'')*')"
    r"|(?P<ident>[A-Za-z_][A-Za-z_0-9]*)"
    r"|(?P<op><=|>=|<>|!=|==|[-+*/(),%=<>.])"
    r")")


def _tokenize(text: str) -> List[Tuple[str, object]]:
    toks: List[Tuple[str, object]] = []
    pos = 0
    while pos < len(text):
        m = _TOKEN_RE.match(text, pos)
        if m is None:
            rest = text[pos:].strip()
            if not rest:
                break
            raise SqlSyntaxError(f"cannot tokenize near {rest[:20]!r}")
        pos = m.end()
        if m.lastgroup == "num":
            toks.append(("num", float(m.group("num"))))
        elif m.lastgroup == "str":
            toks.append(("str", m.group("str")[1:-1].replace("''", "'")))
        elif m.lastgroup == "ident":
            word = m.group("ident")
            if word.upper() in _KEYWORDS:
                toks.append(("kw", word.upper()))
            else:
                toks.append(("ident", word))
        else:
            toks.append(("op", m.group("op")))
    toks.append(("end", None))
    return toks


# ---------------------------------------------------------------------------
# Parser
# ---------------------------------------------------------------------------

_CMP_OPS = {"<": "<", "<=": "<=", ">": ">", ">=": ">=",
            "=": "==", "==": "==", "!=": "!=", "<>": "!="}


class _Parser:
    def __init__(self, toks: List[Tuple[str, object]]):
        self.toks = toks
        self.pos = 0

    # -- token helpers -------------------------------------------------------
    def peek(self) -> Tuple[str, object]:
        return self.toks[self.pos]

    def advance(self) -> Tuple[str, object]:
        t = self.toks[self.pos]
        self.pos += 1
        return t

    def accept_kw(self, *words: str) -> Optional[str]:
        k, v = self.peek()
        if k == "kw" and v in words:
            self.advance()
            return v  # type: ignore[return-value]
        return None

    def accept_op(self, *ops: str) -> Optional[str]:
        k, v = self.peek()
        if k == "op" and v in ops:
            self.advance()
            return v  # type: ignore[return-value]
        return None

    def expect_kw(self, word: str) -> None:
        if self.accept_kw(word) is None:
            raise SqlSyntaxError(f"expected {word}, got {self.peek()[1]!r}")

    def expect_op(self, op: str) -> None:
        if self.accept_op(op) is None:
            raise SqlSyntaxError(f"expected {op!r}, got {self.peek()[1]!r}")

    def expect_ident(self) -> str:
        k, v = self.advance()
        if k != "ident":
            raise SqlSyntaxError(f"expected identifier, got {v!r}")
        return v  # type: ignore[return-value]

    def expect_column(self) -> str:
        """A column reference, optionally table-qualified (``t.col``).
        Column names are globally unique, so the qualifier is stripped."""
        name = self.expect_ident()
        if self.accept_op("."):
            return self.expect_ident()
        return name

    def expect_num(self) -> float:
        k, v = self.advance()
        if k != "num":
            raise SqlSyntaxError(f"expected number, got {v!r}")
        return v  # type: ignore[return-value]

    def expect_signed_num(self) -> float:
        if self.accept_op("-"):
            return -self.expect_num()
        return self.expect_num()

    # -- arithmetic expressions (left-assoc, matching operator overloads) ----
    def parse_arith(self) -> Expr:
        e = self.parse_term()
        while True:
            op = self.accept_op("+", "-")
            if op is None:
                return e
            e = BinOp(op, e, self.parse_term())

    def parse_term(self) -> Expr:
        e = self.parse_factor()
        while True:
            op = self.accept_op("*", "/")
            if op is None:
                return e
            e = BinOp(op, e, self.parse_factor())

    def parse_factor(self) -> Expr:
        if self.accept_op("("):
            e = self.parse_arith()
            self.expect_op(")")
            return e
        if self.accept_op("-"):
            return Const(-self.expect_num())
        k, v = self.peek()
        if k == "num":
            self.advance()
            return Const(float(v))  # type: ignore[arg-type]
        if k == "ident":
            self.advance()
            if self.accept_op("."):  # qualified column: t.col -> col
                return Col(self.expect_ident())
            return Col(v)  # type: ignore[arg-type]
        raise SqlSyntaxError(f"expected expression, got {v!r}")

    # -- predicates ----------------------------------------------------------
    def parse_pred(self) -> Expr:
        return self._parse_or()

    def _parse_or(self) -> Expr:
        # Right fold: a OR b OR c -> Or(a, Or(b, c)).
        left = self._parse_and()
        if self.accept_kw("OR"):
            return Or(left, self._parse_or())
        return left

    def _parse_and(self) -> Expr:
        left = self._parse_not()
        if self.accept_kw("AND"):
            return And(left, self._parse_and())
        return left

    def _parse_not(self) -> Expr:
        if self.accept_kw("NOT"):
            return Not(self._parse_not())
        return self._parse_cmp()

    def _parse_cmp(self) -> Expr:
        # '(' may open either a predicate group or an arithmetic group;
        # try the predicate reading first and backtrack on failure.
        if self.peek() == ("op", "("):
            mark = self.pos
            try:
                self.advance()
                inner = self.parse_pred()
                self.expect_op(")")
                if isinstance(inner, (Cmp, Between, And, Or, Not)):
                    return inner
            except SqlSyntaxError:
                pass
            self.pos = mark
        if self.peek()[0] == "str":
            left: Expr = Str(self.advance()[1])  # type: ignore[arg-type]
        else:
            left = self.parse_arith()
        if self.accept_kw("BETWEEN"):
            if isinstance(left, Str):
                raise SqlSyntaxError(
                    "string literals cannot be BETWEEN operands "
                    "(dictionary order is not lexicographic)")
            lo = self.expect_signed_num()
            self.expect_kw("AND")
            hi = self.expect_signed_num()
            return Between(left, float(lo), float(hi))
        for tok, op in _CMP_OPS.items():
            if self.accept_op(tok):
                if self.peek()[0] == "str":
                    return Cmp(op, left, Str(self.advance()[1]))  # type: ignore[arg-type]
                return Cmp(op, left, self.parse_arith())
        raise SqlSyntaxError(f"expected comparison, got {self.peek()[1]!r}")

    # -- aggregates ----------------------------------------------------------
    def parse_aggcall(self) -> Tuple[str, Optional[Expr]]:
        kw = self.accept_kw("SUM", "AVG", "COUNT")
        if kw is None:
            raise SqlSyntaxError(
                f"expected SUM/AVG/COUNT, got {self.peek()[1]!r}")
        self.expect_op("(")
        if kw == "COUNT":
            self.expect_op("*")
            self.expect_op(")")
            return "count", None
        e = self.parse_arith()
        self.expect_op(")")
        return kw.lower(), e

    def _parse_weighted_sum(self) -> Tuple[float, Expr]:
        weight, sign = 1.0, 1.0
        if self.accept_op("-"):
            sign = -1.0
        k, _ = self.peek()
        if k == "num":
            weight = self.expect_num()
            self.expect_op("*")
        elif sign < 0:
            raise SqlSyntaxError("expected a numeric weight after '-'")
        kind, expr = self.parse_aggcall()
        if kind != "sum":
            raise SqlSyntaxError("composite aggregates combine SUM parts only")
        return sign * float(weight), expr  # type: ignore[return-value]

    def parse_select_item(self, index: int) -> CompositeAgg:
        # a (possibly negative) weight can only open an 'add' composite
        if self.peek()[0] == "num" or self.peek() == ("op", "-"):
            w1, e1 = self._parse_weighted_sum()
            self.expect_op("+")
            w2, e2 = self._parse_weighted_sum()
            kind, expr, expr2, weights = "add", e1, e2, (w1, w2)
        else:
            kind, expr = self.parse_aggcall()
            expr2, weights = None, (1.0, 1.0)
            op = self.accept_op("/", "*", "+")
            if op is not None:
                if kind != "sum":
                    raise SqlSyntaxError(
                        "composite aggregates combine SUM parts only")
                if op == "+":
                    w2, expr2 = self._parse_weighted_sum()
                    kind, weights = "add", (1.0, w2)
                else:
                    kind2, expr2 = self.parse_aggcall()
                    if kind2 != "sum":
                        raise SqlSyntaxError(
                            "composite aggregates combine SUM parts only")
                    kind = "ratio" if op == "/" else "product"
        name = self.expect_ident() if self.accept_kw("AS") else f"agg{index}"
        return CompositeAgg(name, kind, expr, expr2=expr2, weights=weights)

    # -- full query ----------------------------------------------------------
    def parse_query(
        self,
        max_groups_resolver: Optional[Callable[[Tuple[str, ...], str], int]] = None,
        spec_kwargs: Optional[dict] = None,
    ) -> ParsedQuery:
        self.expect_kw("SELECT")
        aggs = [self.parse_select_item(0)]
        while self.accept_op(","):
            aggs.append(self.parse_select_item(len(aggs)))

        self.expect_kw("FROM")
        base = self.expect_ident()
        child: L.Plan = L.Scan(base)
        while self.accept_kw("JOIN"):
            right = self.expect_ident()
            self.expect_kw("ON")
            lk = self.expect_column()
            self.expect_op("=")
            rk = self.expect_column()
            child = L.Join(child, L.Scan(right), lk, rk)

        if self.accept_kw("WHERE"):
            child = L.Filter(child, self.parse_pred())

        group_by, max_groups = None, 1
        if self.accept_kw("GROUP"):
            self.expect_kw("BY")
            group_by = self.expect_column()
            if self.accept_kw("MAXGROUPS"):
                n = self.expect_num()
                if n != int(n):
                    raise SqlSyntaxError(f"MAXGROUPS must be an integer, "
                                         f"got {n!r}")
                max_groups = int(n)
            elif max_groups_resolver is not None:
                tables = tuple(s.table for s in child.scans())
                max_groups = int(max_groups_resolver(tables, group_by))
            if max_groups < 1:
                raise SqlSyntaxError("MAXGROUPS must be >= 1")

        having = None
        if self.accept_kw("HAVING"):
            name = self.expect_ident()
            if name not in {a.name for a in aggs}:
                raise SqlSyntaxError(
                    f"HAVING references {name!r}, which is not a SELECT "
                    f"output (outputs: {[a.name for a in aggs]}); HAVING "
                    "compares an aggregate alias against a number")
            for tok, op in _CMP_OPS.items():
                if self.accept_op(tok):
                    having = HavingClause(name, op, self.expect_signed_num())
                    break
            if having is None:
                raise SqlSyntaxError(
                    f"expected comparison after HAVING {name}, got "
                    f"{self.peek()[1]!r}")

        limit = None
        order_by = None
        desc = False
        if self.accept_kw("ORDER"):
            self.expect_kw("BY")
            order_by = self.expect_ident()
            if order_by not in {a.name for a in aggs}:
                raise SqlSyntaxError(
                    f"ORDER BY references {order_by!r}, which is not a "
                    f"SELECT output (outputs: {[a.name for a in aggs]}); "
                    "ORDER BY ranks by an aggregate alias")
            if self.accept_kw("DESC"):
                desc = True
            else:
                self.accept_kw("ASC")
            if not self.accept_kw("LIMIT"):
                raise SqlSyntaxError(
                    "ORDER BY requires LIMIT: answers are unordered group "
                    "sets, so ordering only exists to select the top n")
            limit = self._finish_limit(order_by, desc)
        elif self.accept_kw("LIMIT"):
            limit = self._finish_limit(None, False)

        spec = None
        if self.accept_kw("ERROR"):
            err = self.expect_num()
            self.expect_op("%")
            self.expect_kw("CONFIDENCE")
            conf = self.expect_num()
            self.expect_op("%")
            try:
                spec = ErrorSpec(error=err / 100.0, confidence=conf / 100.0)
            except ValueError as e:
                # out-of-range targets (ERROR 150%) are dialect violations,
                # not internal errors — reject at the parse stage
                raise SqlSyntaxError(f"invalid ERROR/CONFIDENCE clause: {e}")
            if spec_kwargs:
                # caller-config tunables are applied OUTSIDE the client-error
                # wrapping: a bad server-side override must fail loudly, not
                # masquerade as the client's syntax error
                spec = dataclasses.replace(spec, **spec_kwargs)

        if self.peek()[0] != "end":
            raise SqlSyntaxError(f"trailing input at {self.peek()[1]!r}")
        q = Query(child=child, aggs=tuple(aggs), group_by=group_by,
                  max_groups=max_groups)
        return ParsedQuery(query=q, spec=spec, having=having, limit=limit)

    def _finish_limit(self, order_by: Optional[str],
                      desc: bool) -> LimitClause:
        n = self.expect_num()
        if n != int(n) or int(n) < 1:
            raise SqlSyntaxError(
                f"LIMIT must be a positive integer, got {n!r}")
        return LimitClause(n=int(n), order_by=order_by, desc=desc)


def parse_sql(
    text: str,
    *,
    max_groups_resolver: Optional[Callable[[Tuple[str, ...], str], int]] = None,
    spec_kwargs: Optional[dict] = None,
) -> ParsedQuery:
    """Parse dialect SQL into the internal (Query, ErrorSpec) representation.

    ``max_groups_resolver(tables, column)`` — called with every table in the
    FROM/JOIN chain — supplies ``max_groups`` for GROUP BY queries that omit
    MAXGROUPS; ``spec_kwargs`` overrides TAQA tunables
    on the lowered :class:`ErrorSpec` (e.g. ``{"min_pilot_blocks": 50}``).
    """
    return _Parser(_tokenize(text)).parse_query(max_groups_resolver,
                                                spec_kwargs)


# ---------------------------------------------------------------------------
# String-literal lowering (dictionary-encoded columns)
# ---------------------------------------------------------------------------

# Mirrored comparison for literal-on-the-left spellings: 'N' < col == col > 'N'
_MIRROR_CMP = {"<": ">", "<=": ">=", ">": "<", ">=": "<="}


def _resolve_strings_expr(e: Expr, resolver, order_resolver=None) -> Expr:
    if isinstance(e, Cmp):
        ls, rs = isinstance(e.left, Str), isinstance(e.right, Str)
        if not (ls or rs):
            return e
        if ls and rs:
            raise UnsupportedSqlError(
                "comparing two string literals is not a table predicate")
        col, lit = (e.right, e.left) if ls else (e.left, e.right)
        if not isinstance(col, Col):
            raise UnsupportedSqlError(
                f"string literal {lit.value!r} must compare against a "
                "column, not an expression")
        if e.op in ("==", "!="):
            code = Const(float(resolver(col.name, lit.value)))
            return Cmp(e.op, code, col) if ls else Cmp(e.op, col, code)
        # Order comparison: valid only against a SORTED dictionary (code
        # order == string order); the order resolver owns that check and
        # returns the bisection boundary as the lowered (op, code).
        if order_resolver is None:
            raise UnsupportedSqlError(
                f"dictionary-encoded columns support = and != only, "
                f"got {e.op!r} (no sorted-dictionary order resolver)")
        op = _MIRROR_CMP[e.op] if ls else e.op
        lowered_op, code = order_resolver(col.name, lit.value, op)
        return Cmp(lowered_op, col, Const(float(code)))
    if isinstance(e, And):
        return And(_resolve_strings_expr(e.left, resolver, order_resolver),
                   _resolve_strings_expr(e.right, resolver, order_resolver))
    if isinstance(e, Or):
        return Or(_resolve_strings_expr(e.left, resolver, order_resolver),
                  _resolve_strings_expr(e.right, resolver, order_resolver))
    if isinstance(e, Not):
        return Not(_resolve_strings_expr(e.arg, resolver, order_resolver))
    if isinstance(e, Between) and isinstance(e.arg, Str):
        # unreachable from the parser (rejected there); guards hand-built
        # plans so no Str survives to execution
        raise UnsupportedSqlError(
            "string literals cannot be BETWEEN operands")
    return e


def _resolve_strings_plan(p: L.Plan, resolver, order_resolver=None) -> L.Plan:
    if isinstance(p, L.Filter):
        return dataclasses.replace(
            p, child=_resolve_strings_plan(p.child, resolver, order_resolver),
            pred=_resolve_strings_expr(p.pred, resolver, order_resolver))
    if isinstance(p, L.Join):
        return dataclasses.replace(
            p, left=_resolve_strings_plan(p.left, resolver, order_resolver),
            right=_resolve_strings_plan(p.right, resolver, order_resolver))
    if isinstance(p, L.Union):
        return dataclasses.replace(
            p, inputs=tuple(_resolve_strings_plan(c, resolver, order_resolver)
                            for c in p.inputs))
    return p


def resolve_string_literals(query: Query, resolver,
                            order_resolver=None) -> Query:
    """Lower every string-literal comparison to integer dictionary codes.

    ``resolver(column, literal) -> int`` handles equality (``=`` / ``!=``);
    ``order_resolver(column, literal, op) -> (op, code)`` handles order
    comparisons over *sorted* dictionaries, returning the bisection-boundary
    code and the (possibly strictness-adjusted) operator — omit it to keep
    the historical equality-only behaviour.

    The engine is numeric; this is the only path by which a :class:`Str`
    node may reach execution, and it removes them all.  Resolvers raise
    :class:`UnsupportedSqlError` for columns without a dictionary, literals
    outside it, or order comparisons against unsorted dictionaries (see
    :meth:`repro_torch.api.Session.register_dictionary`).  Queries without string
    literals are returned unchanged.
    """
    child = _resolve_strings_plan(query.child, resolver, order_resolver)
    if child == query.child:
        return query
    return dataclasses.replace(query, child=child)


# ---------------------------------------------------------------------------
# Renderer (the inverse direction, for round-trip tests and logging)
# ---------------------------------------------------------------------------

_PREC = {"+": 1, "-": 1, "*": 2, "/": 2}


def _num(v: float) -> str:
    f = float(v)
    if f.is_integer() and abs(f) < 1e15:
        return str(int(f))
    return repr(f)


def _pct(frac: float) -> str:
    """Shortest percent literal p with float(p)/100 == frac (exact re-parse);
    naive ``frac * 100`` drifts (0.05 * 100 == 5.000000000000001)."""
    for digits in range(0, 18):
        s = f"{frac * 100:.{digits}f}"
        if "." in s:
            s = s.rstrip("0").rstrip(".")
        if s and float(s) / 100.0 == frac:
            return s
    return repr(frac * 100)


def _render_arith(e: Expr, parent_prec: int = 0, right: bool = False) -> str:
    if isinstance(e, Col):
        return e.name
    if isinstance(e, Const):
        return _num(e.value)
    if isinstance(e, Str):
        return "'" + e.value.replace("'", "''") + "'"
    if isinstance(e, BinOp):
        p = _PREC[e.op]
        s = (f"{_render_arith(e.left, p, False)} {e.op} "
             f"{_render_arith(e.right, p, True)}")
        # Parenthesize when re-parsing (left-assoc, precedence-climbing)
        # would otherwise reassociate the tree.
        if p < parent_prec or (p == parent_prec and right):
            return f"({s})"
        return s
    raise UnsupportedSqlError(f"not an arithmetic expression: {e!r}")


_SQL_CMP = {"==": "=", "!=": "!=", "<": "<", "<=": "<=", ">": ">", ">=": ">="}


def _conjunction_terms(e: Expr) -> List[Expr]:
    """Flatten a top-level AND chain (any association) into its terms."""
    if isinstance(e, And):
        return _conjunction_terms(e.left) + _conjunction_terms(e.right)
    return [e]


def _render_pred(e: Expr) -> str:
    if isinstance(e, Or):
        left = _render_pred(e.left)
        if isinstance(e.left, Or):  # left-nested Or needs explicit grouping
            left = f"({left})"
        return f"{left} OR {_render_pred(e.right)}"
    if isinstance(e, And):
        def side(x: Expr, is_left: bool) -> str:
            s = _render_pred(x)
            if isinstance(x, Or) or (is_left and isinstance(x, And)):
                return f"({s})"
            return s
        return f"{side(e.left, True)} AND {side(e.right, False)}"
    if isinstance(e, Not):
        return f"NOT ({_render_pred(e.arg)})"
    if isinstance(e, Cmp):
        return (f"{_render_arith(e.left)} {_SQL_CMP[e.op]} "
                f"{_render_arith(e.right)}")
    if isinstance(e, Between):
        return (f"{_render_arith(e.arg)} BETWEEN {_num(e.lo)} AND "
                f"{_num(e.hi)}")
    raise UnsupportedSqlError(f"not a predicate: {e!r}")


def _render_agg(a: CompositeAgg) -> str:
    if a.kind == "sum":
        body = f"SUM({_render_arith(a.expr)})"
    elif a.kind == "count":
        body = "COUNT(*)"
    elif a.kind == "avg":
        body = f"AVG({_render_arith(a.expr)})"
    elif a.kind == "ratio":
        body = f"SUM({_render_arith(a.expr)}) / SUM({_render_arith(a.expr2)})"
    elif a.kind == "product":
        body = f"SUM({_render_arith(a.expr)}) * SUM({_render_arith(a.expr2)})"
    elif a.kind == "add":
        w1, w2 = a.weights
        s1, s2 = (f"SUM({_render_arith(a.expr)})",
                  f"SUM({_render_arith(a.expr2)})")
        if w1 != 1.0:
            s1 = f"{_num(w1)} * {s1}"
        if w2 != 1.0:
            s2 = f"{_num(w2)} * {s2}"
        body = f"{s1} + {s2}"
    else:
        raise UnsupportedSqlError(f"composite kind {a.kind!r}")
    return f"{body} AS {a.name}"


def render_sql(query: Query, spec: Optional[ErrorSpec] = None,
               having: Optional[HavingClause] = None,
               limit: Optional[LimitClause] = None) -> str:
    """Render the internal representation back to dialect SQL.

    Only the dialect surface is expressible: a single optional Filter over a
    left-deep Join chain over plain Scans.  TABLESAMPLE clauses and Unions
    raise :class:`UnsupportedSqlError` — those are TAQA's rewriting
    intermediates, not user queries.  ``having`` and ``limit`` re-emit the
    post-aggregation :class:`HavingClause` / :class:`LimitClause`
    (round-trip through :func:`parse_sql`; ASC, the default direction, is
    left implicit).
    """
    preds: List[Expr] = []
    node: L.Plan = query.child
    while isinstance(node, L.Filter):
        preds.append(node.pred)
        node = node.child
    joins: List[Tuple[str, str, str]] = []
    while isinstance(node, L.Join):
        if not isinstance(node.right, L.Scan):
            raise UnsupportedSqlError("join right side must be a plain Scan")
        if node.right.sample is not None:
            raise UnsupportedSqlError("TABLESAMPLE is not renderable SQL")
        joins.append((node.right.table, node.left_key, node.right_key))
        node = node.left
    if not isinstance(node, L.Scan):
        raise UnsupportedSqlError(f"unsupported plan shape at {node!r}")
    if node.sample is not None:
        raise UnsupportedSqlError("TABLESAMPLE is not renderable SQL")

    parts = ["SELECT " + ", ".join(_render_agg(a) for a in query.aggs),
             f"FROM {node.table}"]
    for table, lk, rk in reversed(joins):
        parts.append(f"JOIN {table} ON {lk} = {rk}")
    if preds:
        # Canonical WHERE: flatten every nested Filter's top-level AND chain
        # into one deterministic term list — application order, i.e.
        # innermost filter first, left-to-right within each chain — and
        # re-fold RIGHT exactly as the parser folds, so render∘parse is a
        # fixpoint and nested-Filter plans collapse to one stable clause.
        terms = [t for p in reversed(preds) for t in _conjunction_terms(p)]
        pred = terms[-1]
        for t in reversed(terms[:-1]):
            pred = And(t, pred)
        parts.append(f"WHERE {_render_pred(pred)}")
    if query.group_by is not None:
        clause = f"GROUP BY {query.group_by}"
        if query.max_groups != 1:
            clause += f" MAXGROUPS {query.max_groups}"
        parts.append(clause)
    if having is not None:
        if having.agg not in {a.name for a in query.aggs}:
            raise UnsupportedSqlError(
                f"HAVING references {having.agg!r}, not a query output")
        parts.append(f"HAVING {having.agg} {_SQL_CMP[having.op]} "
                     f"{_num(having.value)}")
    if limit is not None:
        if limit.order_by is not None:
            if limit.order_by not in {a.name for a in query.aggs}:
                raise UnsupportedSqlError(
                    f"ORDER BY references {limit.order_by!r}, "
                    "not a query output")
            parts.append(f"ORDER BY {limit.order_by}"
                         + (" DESC" if limit.desc else ""))
        parts.append(f"LIMIT {limit.n}")
    if spec is not None:
        parts.append(f"ERROR {_pct(spec.error)}% "
                     f"CONFIDENCE {_pct(spec.confidence)}%")
    return " ".join(parts)
