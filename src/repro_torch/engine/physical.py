"""Physical plans: compiled single-table query pipelines over the kernels.

``PhysicalCompiler`` lowers a :class:`logical.Aggregate` to a callable and
caches it under a *plan signature* — the operator tree with sampling
rates/seeds stripped AND predicate/expression constants hoisted
(:func:`logical.extract_constants`), the referenced columns and dtypes,
``block_rows``, and the bucketed sampled-block count.  Constants reach the
callable as a runtime ``params`` vector on the device, so one entry serves
every constant variant of a shape.

Routes (this slice of the port: one table, no GROUP BY):

* ``filtered_agg`` — ``Aggregate(Filter+(Scan))`` over a block-sampled
  table with a conjunctive range predicate and COUNT / SUM(col) /
  SUM(a*b) channels lowers onto :func:`repro_torch.kernels.filtered_agg`
  (the TPC-H Q6 shape).
* ``block_agg``    — filterless ``Aggregate(Scan)`` over a block-sampled
  table with COUNT / SUM(col) channels lowers onto
  :func:`repro_torch.kernels.block_agg`.
* ``torch_scan``   — an exact (unsampled) ungrouped ``Aggregate(Filter*(Scan))``
  is one pass of plain tensor ops over the whole table.

The route depends on the plan's shape alone, never on the device: a CUDA
table runs the hand-written kernels, a CPU table runs their plain PyTorch
versions through the same wrappers.  Sums over blocks are ``torch.sum`` over
fixed shapes — no atomics, so answers are deterministic run to run.  Joins,
unions, GROUP BY, row sampling, pair tables and predicates or channels the
kernels cannot take raise :class:`NotImplementedError` naming the later
slice that ports them.

Scan-cost attribution lives here too: ``n_real · block_rows · row_bytes``
for block-sampled scans, full table bytes for exact scans.
"""

from __future__ import annotations

import dataclasses
import functools
import threading
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch.engine import logical as L
from repro_torch.engine.expr import And, Between, BinOp, Cmp, Col, Expr, eval_expr
from repro_torch.engine.table import BlockTable
from repro_torch.kernels.block_agg import block_agg
from repro_torch.kernels.filtered_agg import filtered_agg

_BIG_BOUND = 3.0e38       # "unbounded" predicate slot, f32-safe

_LATER = ("the port's single-table slice takes Aggregate(Filter*(Scan)) "
          "without GROUP BY; {what} waits for the gather route of a later "
          "slice (ROADMAP queue 1, item 4)")


def _not_yet(what: str) -> NotImplementedError:
    return NotImplementedError(_LATER.format(what=what))


# ---------------------------------------------------------------------------
# Scan-cost attribution
# ---------------------------------------------------------------------------

def scan_cost_bytes(table: BlockTable, method: str, n_real: int = 0) -> int:
    """Bytes a scan of ``table`` moves: only the real sampled slabs for a
    block-sampled scan (padding ids move nothing in a real storage engine),
    the full table otherwise."""
    if method == "block":
        return n_real * table.block_rows * table.row_bytes()
    return table.total_bytes()


# ---------------------------------------------------------------------------
# Runtime sampling decisions (the host-side TABLESAMPLE draw)
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class ScanRuntime:
    """Per-table runtime inputs of a compiled callable.

    ``ids`` is the host draw padded to the bucketed length ``n_phys`` with
    zeros; rows past ``n_real`` are masked out after the kernels, so nearby
    sample sizes share one cache entry.
    """

    method: str                             # "none" | "block"
    n_real: int = 0                         # real sampled blocks (block)
    n_phys: int = 0                         # bucketed physical block count
    ids: Optional[np.ndarray] = None        # (n_phys,) int32, zero-padded

    def sig(self) -> tuple:
        if self.method == "block":
            return ("block", self.n_phys)
        return (self.method,)


# ---------------------------------------------------------------------------
# Plan signatures
# ---------------------------------------------------------------------------

@functools.lru_cache(maxsize=1024)
def _template_of(plan: L.Plan) -> Tuple[L.Plan, Tuple[float, ...]]:
    """Memoized constant hoisting (plans are frozen/hashable)."""
    return L.extract_constants(plan)


def plan_template(plan: L.Plan) -> L.Plan:
    """The constant-free template of ``plan`` (Params in constant slots)."""
    return _template_of(plan)[0]


def plan_constants(plan: L.Plan) -> np.ndarray:
    """The runtime constant vector of ``plan``, position-aligned with its
    template's Param slots — the ``params`` operand of compiled callables."""
    return np.asarray(_template_of(plan)[1], np.float32)


def plan_signature(plan: L.Plan, runtimes: Optional[Dict[str, ScanRuntime]] = None,
                   extra: tuple = ()) -> tuple:
    """Hashable structural key for the compile cache: sampling rates and
    seeds stripped, which tables are sampled and at which bucketed size
    kept, predicate constants hoisted into Param slots."""
    rsig = tuple(sorted((t, r.sig()) for t, r in (runtimes or {}).items()))
    return (plan_template(L.strip_samples(plan)), rsig, tuple(extra))


def _referenced_columns(plan: L.Plan) -> set:
    cols: set = set()

    def walk(p: L.Plan):
        if isinstance(p, L.Aggregate):
            for a in p.aggs:
                if a.expr is not None:
                    cols.update(a.expr.columns())
            if p.group_by is not None:
                cols.add(p.group_by)
            walk(p.child)
        elif isinstance(p, L.Filter):
            cols.update(p.pred.columns())
            walk(p.child)
        elif isinstance(p, L.Join):
            cols.add(p.left_key)
            cols.add(p.right_key)
            walk(p.left)
            walk(p.right)
        elif isinstance(p, L.Union):
            for c in p.inputs:
                walk(c)
        elif isinstance(p, L.Scan):
            pass
        else:
            raise TypeError(p)

    walk(plan)
    return cols


def _needed_by_table(plan: L.Plan, catalog: Dict[str, BlockTable]) -> Dict[str, Tuple[str, ...]]:
    """Referenced columns per scanned table."""
    referenced = _referenced_columns(plan)
    needed: Dict[str, Tuple[str, ...]] = {}
    for s in plan.scans():
        tab = catalog[s.table]
        needed[s.table] = tuple(sorted(referenced.intersection(tab.columns)))
    return needed


# ---------------------------------------------------------------------------
# Kernel-shape matching (plan suffix -> kernel lowering)
# ---------------------------------------------------------------------------

def _single_table_chain(child: L.Plan, table: str) -> Optional[List[Expr]]:
    """If ``child`` is Filter*(Scan(table)), return its predicates (maybe [])."""
    preds: List[Expr] = []
    node = child
    while isinstance(node, L.Filter):
        preds.append(node.pred)
        node = node.child
    if isinstance(node, L.Scan) and node.table == table:
        return preds
    return None


def _flatten_conjuncts(pred: Expr) -> List[Expr]:
    if isinstance(pred, And):
        return _flatten_conjuncts(pred.left) + _flatten_conjuncts(pred.right)
    return [pred]


def _match_q6_bounds(preds: List[Expr]) -> Optional[Tuple[Tuple[str, str, str], tuple]]:
    """Map a conjunctive range predicate onto filtered_agg's fixed slots.

    The kernel evaluates ``lo1<=f1<=hi1 AND lo2<=f2<=hi2 AND f3<c3`` with
    runtime bounds.  Two-sided/non-strict conditions fill the f1/f2 slots, a
    single strict upper bound fills f3; unused slots are padded with ±3e38
    (never binding for f32 data).  Bound slots are either a plain float (the
    sentinels) or a constant-free :class:`Expr` (Param slots of a template
    plan) evaluated against the params vector.  Returns ((f1,f2,f3) column
    names, 5 bound slots) or None when the predicate doesn't fit.
    """
    conjuncts: List[Expr] = []
    for p in preds:
        conjuncts.extend(_flatten_conjuncts(p))
    two_sided: List[Tuple[str, object, object]] = []
    strict: List[Tuple[str, object]] = []
    for c in conjuncts:
        if isinstance(c, Between) and isinstance(c.arg, Col):
            two_sided.append((c.arg.name, c.lo, c.hi))
        elif isinstance(c, Cmp) and isinstance(c.left, Col) and not c.right.columns():
            v = c.right
            if c.op == "<":
                strict.append((c.left.name, v))
            elif c.op == "<=":
                two_sided.append((c.left.name, -_BIG_BOUND, v))
            elif c.op == ">=":
                two_sided.append((c.left.name, v, _BIG_BOUND))
            else:
                return None
        else:
            return None
    if len(two_sided) > 2 or len(strict) > 1:
        return None
    anchor = (two_sided + [(s[0], -_BIG_BOUND, _BIG_BOUND) for s in strict])
    if not anchor:
        return None  # no predicate at all: the block_agg route handles it
    while len(two_sided) < 2:
        two_sided.append((anchor[0][0], -_BIG_BOUND, _BIG_BOUND))
    if not strict:
        strict.append((anchor[0][0], _BIG_BOUND))
    (f1, lo1, hi1), (f2, lo2, hi2) = two_sided
    f3, c3 = strict[0]
    return (f1, f2, f3), (lo1, hi1, lo2, hi2, c3)


def _bounds_vector(slots: tuple, params: torch.Tensor) -> torch.Tensor:
    """The 5 kernel bound slots as a (5,) f32 vector on ``params``' device.

    Param slots are read from the device params vector (no host sync); the
    ±3e38 sentinels are f32 constants.  Everything stays f32: a bound that
    reached f64 would flip rows lying exactly on it (``l_discount = k/100``).
    """
    vals = []
    for s in slots:
        if isinstance(s, Expr):
            v = eval_expr(s, {}, params)
            vals.append(torch.as_tensor(v, dtype=torch.float32, device=params.device))
        else:
            vals.append(torch.tensor(s, dtype=torch.float32, device=params.device))
    return torch.stack(vals)


def _match_channels(exprs: Sequence[Optional[Expr]], *, products: bool):
    """Channels as kernel-computable specs.

    ``products=True`` (filtered route) accepts COUNT / SUM(col) / SUM(a*b);
    ``products=False`` (block route) accepts COUNT / SUM(col).  Returns a
    list of ("count",) | ("prod", x, y|None) specs, or None on mismatch.
    """
    specs = []
    for e in exprs:
        if e is None:
            specs.append(("count",))
        elif isinstance(e, Col):
            specs.append(("prod", e.name, None))
        elif (products and isinstance(e, BinOp) and e.op == "*"
              and isinstance(e.left, Col) and isinstance(e.right, Col)):
            specs.append(("prod", e.left.name, e.right.name))
        else:
            return None
    return specs


# ---------------------------------------------------------------------------
# Compiled callables
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class _CompiledBase:
    fn: Callable
    catalog: Dict[str, BlockTable]
    needed: Dict[str, Tuple[str, ...]]
    methods: Dict[str, str]
    route: str

    def _runtime_args(self, runtimes: Dict[str, ScanRuntime], params=()) -> dict:
        """Host draws and constants as device tensors.  Block ids are range
        checked here, on the host, because the kernels index with them."""
        dev = next(iter(self.catalog[t] for t in self.needed)).device
        rt = {"ids": {}, "nreal": {},
              "params": torch.as_tensor(np.asarray(params, np.float32), device=dev)}
        for name in self.needed:
            if self.methods.get(name, "none") != "block":
                continue
            r = runtimes[name]
            ids = np.ascontiguousarray(r.ids, dtype=np.int32)
            nb = self.catalog[name].num_blocks
            if ids.shape != (r.n_phys,) or (len(ids) and (
                    ids.min() < 0 or ids.max() >= nb)):
                raise ValueError(
                    f"block ids of {name!r} must be ({r.n_phys},) in [0, {nb})")
            rt["ids"][name] = torch.from_numpy(ids).to(dev)
            rt["nreal"][name] = r.n_real
        return rt

    def __call__(self, runtimes: Dict[str, ScanRuntime], params=()):
        return self.fn(self._runtime_args(runtimes, params))

    def scanned_bytes(self, runtimes: Dict[str, ScanRuntime]) -> int:
        """Total scan cost of one run (see :func:`scan_cost_bytes`)."""
        total = 0
        for name in self.needed:
            method = self.methods.get(name, "none")
            n_real = runtimes[name].n_real if method == "block" else 0
            total += scan_cost_bytes(self.catalog[name], method, n_real)
        return total


@dataclasses.dataclass
class CompiledQuery(_CompiledBase):
    """fn(rt) -> (sums (num_channels, 1), counts (1,)), f32 on the device."""


@dataclasses.dataclass
class CompiledPilot(_CompiledBase):
    """fn(rt) -> (block_sums (n_phys, 1, num_channels), group_present (1,)
    bool), on the device; rows past n_real are zero."""


@dataclasses.dataclass
class CacheInfo:
    hits: int = 0
    misses: int = 0
    size: int = 0


class PhysicalCompiler:
    """Lowers logical plans to compiled callables, with a signature cache."""

    def __init__(self, catalog: Dict[str, BlockTable]):
        self.catalog = catalog
        self._cache: Dict[tuple, _CompiledBase] = {}
        self._lock = threading.Lock()
        self.hits = 0
        self.misses = 0

    def cache_info(self) -> CacheInfo:
        with self._lock:
            return CacheInfo(self.hits, self.misses, len(self._cache))

    def _geometry_sig(self, needed) -> tuple:
        out = []
        for t in sorted(needed):
            tab = self.catalog[t]
            out.append((t, tab.block_rows, tab.padded_rows, tab.num_origin_blocks,
                        str(tab.device),
                        tuple((c, str(tab.columns[c].dtype)) for c in needed[t])))
        return tuple(out)

    def _lookup(self, key, build):
        with self._lock:
            entry = self._cache.get(key)
            if entry is not None:
                self.hits += 1
                return entry
            self.misses += 1
        compiled = build()
        with self._lock:
            return self._cache.setdefault(key, compiled)

    # -- final / plain queries ----------------------------------------------
    def compile_query(self, plan: L.Aggregate,
                      runtimes: Dict[str, ScanRuntime]) -> CompiledQuery:
        needed = _needed_by_table(plan, self.catalog)
        key = ("query", plan_signature(plan, runtimes,
                                       self._geometry_sig(needed)))
        return self._lookup(key, lambda: self._build_query(
            plan_template(plan), runtimes, needed))

    def _build_query(self, template, runtimes, needed) -> CompiledQuery:
        methods = {t: r.method for t, r in runtimes.items()}
        exprs = tuple(None if a.op == "count" else a.expr for a in template.aggs)
        if template.max_groups != 1 or template.group_by is not None:
            raise _not_yet("GROUP BY")
        if len(runtimes) != 1:
            raise _not_yet("a join or union")
        (table, method), = methods.items()
        preds = _single_table_chain(template.child, table)
        if preds is None:
            raise _not_yet("a join or union")
        if method == "none":
            run, route = self._exact_scan(table, preds, exprs), "torch_scan"
        elif method == "block":
            lowered = self._lower_block_stats(table, preds, exprs)
            if lowered is None:
                raise _not_yet("a predicate or aggregate the kernels cannot take")
            stats_fn, route = lowered

            def run(rt):
                ch, cnt = stats_fn(rt)      # (n_phys, n_ch), (n_phys,)
                return ch.sum(dim=0)[:, None], cnt.sum()[None]
        else:
            raise _not_yet(f"{method!r} sampling")
        return CompiledQuery(fn=run, catalog=self.catalog, needed=needed,
                             methods=methods, route=route)

    def _exact_scan(self, table: str, preds: List[Expr],
                    exprs: Sequence[Optional[Expr]]):
        """The unsampled ungrouped scan: predicates and channels evaluated
        over whole columns in f32 against the device params vector, then
        one ``torch.sum`` per channel."""
        tab = self.catalog[table]

        def run(rt):
            params = rt["params"]
            keep = tab.valid
            for p in preds:
                keep = keep & eval_expr(p, tab.columns, params)
            zero = torch.zeros((), dtype=torch.float32, device=keep.device)
            sums = []
            for e in exprs:
                if e is None:
                    v = keep.to(torch.float32)
                else:
                    v = torch.where(keep, torch.as_tensor(
                        eval_expr(e, tab.columns, params),
                        device=keep.device).to(torch.float32), zero)
                sums.append(v.sum())
            return torch.stack(sums)[:, None], keep.to(torch.float32).sum()[None]

        return run

    # -- pilot queries -------------------------------------------------------
    def compile_pilot(self, plan: L.Aggregate, pilot_table: str,
                      runtime: ScanRuntime,
                      pair_table: Optional[str] = None) -> CompiledPilot:
        if pair_table is not None:
            raise _not_yet("join-pair pilot statistics")
        needed = _needed_by_table(plan, self.catalog)
        key = ("pilot", pilot_table,
               plan_signature(plan, {pilot_table: runtime},
                              self._geometry_sig(needed)))
        return self._lookup(key, lambda: self._build_pilot(
            plan_template(plan), pilot_table, needed))

    def _build_pilot(self, plan, pilot_table, needed) -> CompiledPilot:
        # One channel per simple aggregate plus the trailing "__rows" channel
        # (group presence + COUNT/AVG planning), matching PilotStats.
        exprs = tuple([None if a.op == "count" else a.expr for a in plan.aggs] + [None])
        if plan.max_groups != 1 or plan.group_by is not None:
            raise _not_yet("GROUP BY")
        preds = _single_table_chain(plan.child, pilot_table)
        if preds is None:
            raise _not_yet("a join or union")
        lowered = self._lower_block_stats(pilot_table, preds, exprs)
        if lowered is None:
            raise _not_yet("a predicate or aggregate the kernels cannot take")
        stats_fn, route = lowered

        def run(rt):
            ch, _ = stats_fn(rt)               # (n_phys, n_ch)
            present = (ch[:, -1].sum() > 0)[None]
            return ch[:, None, :], present

        return CompiledPilot(fn=run, catalog=self.catalog, needed=needed,
                             methods={pilot_table: "block"}, route=route)

    # -- kernel lowering of per-block stats ----------------------------------
    def _lower_block_stats(self, table: str, preds: List[Expr],
                           exprs: Sequence[Optional[Expr]]):
        """Lower Filter*(Scan) per-block channel stats onto the kernels.

        Returns (stats_fn, route) where ``stats_fn(rt)`` yields
        ``(channel_sums (n_phys, n_ch), counts (n_phys,))`` with padding rows
        (beyond n_real) zeroed, or None when the shape doesn't fit a kernel.
        The kernels read the table's columns in their stored dtypes; no
        column is cast, padded or materialised per call.
        """
        tab = self.catalog[table]
        br = tab.block_rows
        if preds:
            q6 = _match_q6_bounds(preds)
            specs = _match_channels(exprs, products=True)
            if q6 is None or specs is None:
                return None
            (f1, f2, f3), slots = q6

            def stats_fn(rt):
                cols = tab.columns
                ids = rt["ids"][table]
                bounds = _bounds_vector(slots, rt["params"])
                outs = {}
                for spec in specs:
                    if spec[0] != "prod" or spec[1:] in outs:
                        continue
                    y = None if spec[2] is None else cols[spec[2]]
                    outs[spec[1:]] = filtered_agg(
                        cols[spec[1]], y, cols[f1], cols[f2], cols[f3],
                        tab.valid, br, ids, bounds)
                if not outs:  # COUNT-only query: any column works for cnt
                    c0 = cols[f1]
                    outs[None] = filtered_agg(c0, c0, cols[f1], cols[f2],
                                              cols[f3], tab.valid, br, ids, bounds)
                cnt = next(iter(outs.values()))[:, 0]
                chans = [cnt if s[0] == "count" else outs[s[1:]][:, 1] for s in specs]
                return _mask_padding(torch.stack(chans, dim=1), cnt,
                                     rt["nreal"][table])

            return stats_fn, "filtered_agg"

        specs = _match_channels(exprs, products=False)
        if specs is None:
            return None

        def stats_fn(rt):
            cols = tab.columns
            ids = rt["ids"][table]
            outs = {}
            for spec in specs:
                if spec[0] == "prod" and spec[1] not in outs:
                    outs[spec[1]] = block_agg(cols[spec[1]], tab.valid, br, ids)
            if not outs:  # COUNT-only: the cnt lane ignores the value column
                outs[None] = block_agg(tab.valid, tab.valid, br, ids)
            cnt = next(iter(outs.values()))[:, 0]
            chans = [cnt if s[0] == "count" else outs[s[1]][:, 1] for s in specs]
            return _mask_padding(torch.stack(chans, dim=1), cnt,
                                 rt["nreal"][table])

        return stats_fn, "block_agg"


def _mask_padding(chans: torch.Tensor, cnt: torch.Tensor, n_real: int):
    """Zero the rows of padding ids (positions >= n_real), as a multiply by
    a 0/1 f32 mask like the reference's."""
    n_phys = chans.shape[0]
    mask = (torch.arange(n_phys, device=chans.device) < n_real).to(torch.float32)
    return chans * mask[:, None], cnt * mask
