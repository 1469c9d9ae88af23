"""Physical plans: compiled query pipelines over the kernels.

``PhysicalCompiler`` lowers a :class:`logical.Aggregate` to a callable and
caches it under a *plan signature* — the operator tree with sampling
rates/seeds stripped AND predicate/expression constants hoisted
(:func:`logical.extract_constants`), the referenced columns and dtypes,
``block_rows`` and the geometry of every scanned table, ``max_groups``, and
the bucketed sampled-block count.  Constants reach the callable as a runtime
``params`` vector on the device, so one entry serves every constant variant
of a shape.

Routes:

* ``filtered_agg`` — ``Aggregate(Filter+(Scan))`` over one block-sampled
  table, no GROUP BY, with a conjunctive range predicate and COUNT /
  SUM(col) / SUM(a*b) channels lowers onto
  :func:`repro_torch.kernels.filtered_agg` (the TPC-H Q6 shape).
* ``block_agg``    — filterless ``Aggregate(Scan)`` over one block-sampled
  table, no GROUP BY, with COUNT / SUM(col) channels lowers onto
  :func:`repro_torch.kernels.block_agg`.
* ``torch_scan``   — an exact (unsampled) ungrouped ``Aggregate(Filter*(Scan))``
  is one pass of plain tensor ops over the whole table.
* ``gather``       — everything else: GROUP BY, joins, unions, row sampling
  (TABLESAMPLE BERNOULLI), and predicates or channels the kernels cannot
  take.  The plan is traced over the tables' tensors (:class:`_Tracer`: a
  slab gather for block-sampled scans, a stable sort-and-search for equi
  joins, concatenation for unions) and reduced per group by ONE call of
  :func:`repro_torch.kernels.segment_sum`, the reference's ``xla_gather``
  route and its scatter-add.
* ``filtered_agg_batched`` / ``block_agg_batched`` — a drain group's final
  scans that share one compile key (:meth:`PhysicalCompiler.query_signature`)
  and whose solo route is a kernel run as ONE launch of the batched kernel
  over B lanes (:meth:`PhysicalCompiler.compile_batched_query`).  Each
  lane's stats and its reduction over blocks are the solo route's own calls
  on the solo route's shapes, so lane b is bitwise member b run alone.
* ``gather_batched`` — the other shapes' batch: ONE callable that runs each
  lane through the solo gather body, in lane order (the reference's
  ``lax.map``), so each lane is bitwise the solo run.
* ``fused``        — the single-launch TAQA program of an ungrouped query
  (:meth:`PhysicalCompiler.compile_fused`): the solo pilot body, the f32
  rate solve and the final draw's compaction
  (:mod:`repro_torch.kernels.taqa_solve`), then the solo final body at the
  solo path's bucket, queued with one 8-byte host read between them.

Pilots (per sampled block and group, each channel's sum) take the kernels
where the plan has one group and no join-pair statistics, and the traced
pipeline otherwise, with per-(pilot block, right block) pair sums for a
join's pair table.

Stacked pilots (:meth:`PhysicalCompiler.compile_batched_pilot`): B
same-signature pilots of a drain group as one call.  A kernel-route pilot
takes ONE batched launch per distinct channel column over B id rows
(``filtered_agg_batched`` / ``block_agg_batched``).  A gather-route pilot
whose rows are the pilot table's sampled rows and nothing else traces each
lane as its solo pilot does, concatenates the lanes' rows, offsets lane b's
keys by ``b · n_phys · max_groups``, and reduces every lane in ONE
``segment_sum`` call under the slab claim, whose sums per pilot block do
not depend on the rows or segments around the block.  Either way lane b is
bitwise member b's solo pilot.  The reference stacks its XLA route only and
sends Pallas-route pilots solo; here the kernel route stacks too, since on
the card it is every single-table block-sampled pilot's route.

The route depends on the plan's shape alone, never on the device: a CUDA
table runs the hand-written kernels, a CPU table runs their plain PyTorch
versions through the same wrappers.  No reduction uses atomics, so answers
are the same bits run to run.

Every callable reads its tables from ``rt["catalog"]``, the catalog of the
compiled object it was called through, never from the compiler that built
it.  So shard compilers of one geometry share builds through a
:class:`SharedBuildStore`: an adopted build is rebound to the adopting
compiler's catalog and reads that shard's tensors.

Scan-cost attribution lives here too: ``n_real · block_rows · row_bytes``
for block-sampled scans, full table bytes for row-sampled and exact scans.
"""

from __future__ import annotations

import dataclasses
import functools
import threading
from concurrent.futures import Future
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch.engine import logical as L
from repro_torch.engine.expr import And, Between, BinOp, Cmp, Col, Expr, eval_expr
from repro_torch.engine.table import BlockTable
from repro_torch.kernels.block_agg import block_agg, block_agg_batched
from repro_torch.kernels.filtered_agg import filtered_agg, filtered_agg_batched
from repro_torch.kernels.segment_sum import segment_sum
from repro_torch.kernels.taqa_solve import taqa_draw_compact, taqa_solve_rate
from repro_torch.obs import trace as _trace

_BIG_BOUND = 3.0e38       # "unbounded" predicate slot, f32-safe
_INT_MAX = 2 ** 31 - 1    # join key of an invalid right row


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
    zeros; rows past ``n_real`` are masked out, so nearby sample sizes share
    one cache entry.  ``keep_mask`` is a row-sampled scan's draw over every
    padded row, on the host or already on the table's device.

    ``ids_dev`` / ``nreal_dev`` are device copies of ``ids`` / ``n_real``
    made once by whoever memoizes the draw (a staged sub-draw,
    :mod:`repro_torch.engine.staged`, which range-checks the ids when it
    makes them): a call then uses them as they are, with no host check and
    no host-to-device copy.  They must hold the values of ``ids`` /
    ``n_real``.
    """

    method: str                             # "none" | "block" | "row"
    n_real: int = 0                         # real sampled blocks (block)
    n_phys: int = 0                         # bucketed physical block count
    ids: Optional[np.ndarray] = None        # (n_phys,) int32, zero-padded
    keep_mask: Optional[np.ndarray | torch.Tensor] = None  # (padded_rows,) bool
    ids_dev: Optional[torch.Tensor] = None  # (n_phys,) int32 on the table's device
    nreal_dev: Optional[torch.Tensor] = None  # int32 scalar on the same device

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
# The gather route: per-row channels, per-group keys, a traced pipeline
# ---------------------------------------------------------------------------

def channel_matrix(columns: Dict[str, torch.Tensor], valid: torch.Tensor,
                   exprs: Sequence[Optional[Expr]], params=None) -> torch.Tensor:
    """Every aggregate channel's per-row values: (num_channels, rows) f32.

    ``None`` channels are COUNT (ones).  Invalid rows contribute zeros, so
    one segmented sum over the stacked matrix reduces every channel.
    ``params`` resolves hoisted-constant Param slots of template exprs.
    """
    rows = valid.shape[0]
    zero = torch.zeros((), dtype=torch.float32, device=valid.device)
    outs = []
    for e in exprs:
        if e is None:
            v = torch.ones(rows, dtype=torch.float32, device=valid.device)
        else:
            v = torch.as_tensor(eval_expr(e, columns, params),
                                device=valid.device).to(torch.float32)
            v = v.expand(rows)
        outs.append(torch.where(valid, v, zero))
    return torch.stack(outs)


def _clamp_groups(column: torch.Tensor, max_groups: int) -> torch.Tensor:
    """A group column cut to int32 and clipped to ``[0, max_groups)``."""
    return column.to(torch.int32).clamp(0, max_groups - 1)


def _group_ids(columns: Dict[str, torch.Tensor], valid: torch.Tensor,
               group_by: Optional[str], max_groups: int) -> torch.Tensor:
    """Each row's group id in ``[0, max_groups)`` (int64): the group
    column cut to int32 and clipped, as the reference's segment key.  An
    invalid row (whose channels are all zero) takes group 0, so no key
    depends on what a padding id read: block 0 of the table on a fresh
    draw, position 0 of the rung on a staged one."""
    if group_by is None:
        return torch.zeros(valid.shape[0], dtype=torch.int64, device=valid.device)
    return torch.where(valid, _clamp_groups(columns[group_by], max_groups).to(torch.int64), 0)


@dataclasses.dataclass
class _Traced:
    columns: Dict[str, torch.Tensor]
    valid: torch.Tensor
    block_id: torch.Tensor          # origin block id per row
    pblock: Optional[torch.Tensor]  # compact pilot-block index (pilot lowering)
    block_rows: int
    num_origin_blocks: int


class _Tracer:
    """Evaluates a logical plan over the tables' tensors and one call's
    runtime inputs (block ids, row masks, params).

    The catalog is ``rt["catalog"]``, read when the callable runs, not
    when it is built: a replacement table of the same geometry (same cache
    key) is read, not the old data, and an adopted build reads its own
    shard's.  ``rt`` also holds ``ids`` / ``nreal`` / ``mask`` per table
    and ``params``.
    """

    def __init__(self, needed: Dict[str, Tuple[str, ...]],
                 methods: Dict[str, str],
                 pilot_table: Optional[str] = None,
                 n_phys_pilot: int = 0,
                 pair_table: Optional[str] = None):
        self.needed = needed
        self.methods = methods            # table -> "none" | "block" | "row"
        self.pilot_table = pilot_table
        self.n_phys_pilot = n_phys_pilot  # scratch pblock value == n_phys_pilot
        self.pair_table = pair_table

    # -- scans ---------------------------------------------------------------
    def _scratch_pblock(self, rows: int, device) -> Optional[torch.Tensor]:
        if self.pilot_table is None:
            return None
        return torch.full((rows,), self.n_phys_pilot, dtype=torch.int64,
                          device=device)

    def _trace_scan(self, plan: L.Scan, rt) -> _Traced:
        name = plan.table
        tab = rt["catalog"][name]
        dev = tab.device
        cols = {c: tab.columns[c] for c in self.needed[name]}
        valid, bid = tab.valid, tab.block_id
        method = self.methods.get(name, "none")
        br = tab.block_rows
        if method == "block":
            ids = rt["ids"][name]
            n_phys = ids.shape[0]
            slab = torch.arange(br, dtype=torch.int64, device=dev)
            row_idx = (ids.to(torch.int64)[:, None] * br + slab[None, :]).reshape(-1)
            cols = {c: v[row_idx] for c, v in cols.items()}
            real = (torch.arange(n_phys, device=dev) < rt["nreal"][name]
                    ).repeat_interleave(br)
            valid = valid[row_idx] & real
            bid = bid[row_idx]
            if name == self.pilot_table:
                pblock = torch.arange(n_phys, dtype=torch.int64,
                                      device=dev).repeat_interleave(br)
            else:
                pblock = self._scratch_pblock(n_phys * br, dev)
            return _Traced(cols, valid, bid, pblock, br, tab.num_origin_blocks)
        if method == "row":
            valid = valid & rt["mask"][name]
        return _Traced(cols, valid, bid, self._scratch_pblock(tab.padded_rows, dev),
                       br, tab.num_origin_blocks)

    # -- composite operators -------------------------------------------------
    def trace(self, plan: L.Plan, rt) -> _Traced:
        if isinstance(plan, L.Scan):
            return self._trace_scan(plan, rt)
        if isinstance(plan, L.Filter):
            child = self.trace(plan.child, rt)
            mask = eval_expr(plan.pred, child.columns, rt["params"])
            return dataclasses.replace(child, valid=child.valid & mask)
        if isinstance(plan, L.Join):
            return self._trace_join(plan, rt)
        if isinstance(plan, L.Union):
            return self._trace_union(plan, rt)
        raise TypeError(plan)

    def _trace_join(self, plan: L.Join, rt) -> _Traced:
        """Equi join on a unique right key: a stable argsort of the right
        keys (invalid rows at INT32_MAX) and a left-side search, so a
        duplicate right key matches the row the reference matches."""
        left = self.trace(plan.left, rt)
        right = self.trace(plan.right, rt)
        lkey = left.columns[plan.left_key].to(torch.int32).contiguous()
        rkey = torch.where(right.valid, right.columns[plan.right_key].to(torch.int32),
                           torch.full((), _INT_MAX, dtype=torch.int32,
                                      device=right.valid.device))
        order = torch.argsort(rkey, stable=True)
        sorted_keys = rkey[order]
        pos = torch.searchsorted(sorted_keys, lkey, side="left")
        pos_c = pos.clamp(0, sorted_keys.shape[0] - 1)
        found = sorted_keys[pos_c] == lkey
        match = order[pos_c]
        valid = left.valid & found
        new_cols = dict(left.columns)
        for cname, col in right.columns.items():
            if cname == plan.right_key:
                continue
            if cname in new_cols:
                raise ValueError(f"column name collision in join: {cname}")
            new_cols[cname] = col[match]
        right_scans = plan.right.scans()
        if (self.pair_table is not None and len(right_scans) == 1
                and right_scans[0].table == self.pair_table):
            new_cols[f"__rblock_{self.pair_table}"] = right.block_id[match].to(torch.int64)
        return dataclasses.replace(left, columns=new_cols, valid=valid)

    def _trace_union(self, plan: L.Union, rt) -> _Traced:
        parts = [self.trace(p, rt) for p in plan.inputs]
        names = set(parts[0].columns)
        br = parts[0].block_rows
        offset = 0
        cols = {c: [] for c in names}
        valids, bids, pblocks = [], [], []
        for t in parts:
            if set(t.columns) != names or t.block_rows != br:
                raise ValueError("union inputs must share schema and block size")
            for c in names:
                cols[c].append(t.columns[c])
            valids.append(t.valid)
            bids.append(t.block_id + offset)
            pblocks.append(t.pblock)
            offset += t.num_origin_blocks
        pblock = torch.cat(pblocks) if self.pilot_table is not None else None
        return _Traced({c: torch.cat(v) for c, v in cols.items()},
                       torch.cat(valids), torch.cat(bids), pblock, br, offset)


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

    def _device(self) -> torch.device:
        return next(iter(self.catalog[t] for t in self.needed)).device

    def _runtime_args(self, runtimes: Dict[str, ScanRuntime], params=()) -> dict:
        """Host draws and constants as device tensors.  Fresh block ids are
        range checked here, on the host, because the kernels and the gather
        index with them; memoized device ids (``ids_dev``) were checked when
        they were made and are used as they are."""
        dev = self._device()
        rt = {"catalog": self.catalog, "ids": {}, "nreal": {}, "mask": {},
              "params": torch.as_tensor(np.asarray(params, np.float32), device=dev)}
        for name in self.needed:
            method = self.methods.get(name, "none")
            r = runtimes.get(name)
            if method == "block" and r.ids_dev is not None:
                if tuple(r.ids_dev.shape) != (r.n_phys,) or r.ids_dev.device != dev:
                    raise ValueError(f"device block ids of {name!r} must be "
                                     f"({r.n_phys},) on {dev}")
                rt["ids"][name] = r.ids_dev
                rt["nreal"][name] = r.n_real if r.nreal_dev is None else r.nreal_dev
            elif method == "block":
                ids = np.ascontiguousarray(r.ids, dtype=np.int32)
                nb = self.catalog[name].num_blocks
                if ids.shape != (r.n_phys,) or (len(ids) and (
                        ids.min() < 0 or ids.max() >= nb)):
                    raise ValueError(
                        f"block ids of {name!r} must be ({r.n_phys},) in [0, {nb})")
                rt["ids"][name] = torch.from_numpy(ids).to(dev)
                rt["nreal"][name] = r.n_real
            elif method == "row":
                rt["mask"][name] = self._mask(name, r.keep_mask, dev)
        return rt

    def _mask(self, name: str, keep_mask, dev) -> torch.Tensor:
        rows = self.catalog[name].padded_rows
        mask = torch.as_tensor(keep_mask)
        if mask.dtype != torch.bool or tuple(mask.shape) != (rows,):
            raise ValueError(f"row mask of {name!r} must be ({rows},) bool")
        return mask.to(dev)

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
    """fn(rt) -> (sums (num_channels, max_groups), counts (max_groups,)),
    f32 on the device."""


@dataclasses.dataclass
class CompiledPilot(_CompiledBase):
    """fn(rt) -> (block_sums (n_phys, max_groups, num_channels),
    group_present (max_groups,) bool, pair (n_phys, n_right, num_channels)
    or None), on the device; rows past n_real are zero."""


@dataclasses.dataclass
class CompiledBatch(_CompiledBase):
    """A drain-group batch callable: B same-signature members per call.

    Lanes differ only in their sampled block ids or row masks and their
    hoisted-constant params row.  ``call_batch`` stacks them (a (B, n_phys)
    id matrix and the n_real of each lane per block-sampled table, a
    (B, padded_rows) mask per row-sampled one, a (B, P) params matrix) and
    returns ``fn``'s outputs with a leading lane axis — for a query
    (sums (B, num_channels, max_groups), counts (B, max_groups)) — on the
    device, lane k bitwise member k's solo run.
    """

    batch: int = 0

    def call_batch(self, runtimes_list: Sequence[Dict[str, ScanRuntime]],
                   params_list: Sequence[np.ndarray]):
        if len(runtimes_list) != self.batch or len(params_list) != self.batch:
            raise ValueError(
                f"batch callable built for {self.batch} members, got "
                f"{len(runtimes_list)} runtimes and {len(params_list)} params")
        dev = self._device()
        rt = {"catalog": self.catalog, "ids": {}, "nreal": {}, "mask": {},
              "params": torch.as_tensor(np.asarray(params_list, np.float32)
                                        .reshape(self.batch, -1), device=dev)}
        for name in self.needed:
            method = self.methods.get(name, "none")
            if method == "none":
                continue
            rows = [r[name] for r in runtimes_list]
            if method == "row":
                rt["mask"][name] = torch.stack(
                    [self._mask(name, r.keep_mask, dev) for r in rows])
                continue
            n_phys = rows[0].n_phys
            nb = self.catalog[name].num_blocks
            # range-checked on the host, as _runtime_args does: the kernels
            # and the gather index the table with these ids
            shapes_ok = all(np.shape(r.ids) == (n_phys,) for r in rows)
            ids = np.stack([np.asarray(r.ids, np.int32) for r in rows]) \
                if shapes_ok else None
            if ids is None or (ids.size and (ids.min() < 0 or ids.max() >= nb)):
                raise ValueError(f"block ids of {name!r} must be "
                                 f"({self.batch}, {n_phys}) in [0, {nb})")
            rt["ids"][name] = torch.from_numpy(ids).to(dev)
            rt["nreal"][name] = [r.n_real for r in rows]
        return self.fn(rt)


@dataclasses.dataclass
class CompiledPilotBatch(CompiledBatch):
    """A stacked pilot: B same-signature pilot scans per call (the shared-
    pilot drain group's stage 1).

    ``call_batch`` stacks the member pilot runtimes (a (B, n_phys) id
    matrix, the n_real of each lane, a (B, P) params matrix) and returns
    (block_sums (B, n_phys, max_groups, num_channels), present (B,
    max_groups)) on the device; lane k is bitwise member k's solo pilot.
    ``route`` is ``filtered_agg_batched`` / ``block_agg_batched`` (one
    launch per distinct channel column) or ``gather_stacked`` (one
    ``segment_sum`` call)."""


def _lane_runtimes(rt: dict, batch: int) -> List[dict]:
    """The solo runtime dict of each lane of a stacked one, in lane order:
    lane b holds row b of every stacked input, exactly what its solo call
    holds."""
    return [{"catalog": rt["catalog"],
             "ids": {t: v[b] for t, v in rt["ids"].items()},
             "nreal": {t: v[b] for t, v in rt["nreal"].items()},
             "mask": {t: v[b] for t, v in rt["mask"].items()},
             "params": rt["params"][b]} for b in range(batch)]


def _lanes(run: Callable, rt: dict, batch: int) -> List[tuple]:
    """``run`` on each lane of a stacked runtime dict, in lane order."""
    return [run(member) for member in _lane_runtimes(rt, batch)]


def stack_lane_keys(keys: Sequence[torch.Tensor], width: int) -> torch.Tensor:
    """The keys of B lanes' ``segment_sum`` calls as those of ONE call over
    their concatenated rows: lane b's keys in ``[0, width)`` move to
    ``[b · width, (b + 1) · width)``; any other key (a row in no pilot block
    of its lane, such as the scratch block's) moves to ``B · width``, past
    every lane's segments, so the stacked call drops it as the lane's solo
    call does.  An offset alone would put a scratch key of lane b into lane
    b + 1's first segments."""
    total = len(keys) * width
    return torch.cat([torch.where((k >= 0) & (k < width), k + b * width, total)
                      for b, k in enumerate(keys)])


def fused_buckets(num_blocks: int) -> Tuple[int, ...]:
    """Id-length buckets of the fused final stage.

    Mirrors ``sampling.pad_block_ids``: for any sampled count n in
    [0, num_blocks], ``min(bucket_blocks(max(n, 1)), num_blocks)`` is the
    first of these values that is >= n, so the fused final runs at exactly
    the physical id length the solo path pads to.
    """
    out: List[int] = []
    b = 64
    while b < num_blocks:
        out.append(b)
        b <<= 1
    out.append(num_blocks)
    return tuple(out)


@dataclasses.dataclass
class CompiledFused(_CompiledBase):
    """The single-launch TAQA program (pilot -> rate solve -> final).

    fn(rt) -> (block_sums (n_phys_p, 1, n_ch), present (1,), theta (2,) f32
    [theta, theta_eff], flags int (1 no groups | 2 bad L_mu | 4 no feasible
    plan), nsel int, padded (num_blocks,) int32, sums (n_ch, 1) and counts
    (1,), or None for both where nsel is 0).  Every output but the two ints
    stays on the device.

    ``call_fused`` adds the fused-only runtime operands to the standard
    runtime dict: the per-constraint quantile table ``solve`` (n_solve, 5)
    rows [t_q, chi_q, z, z_bin, e], the shared scalars ``scal`` (6,)
    [N, max_rate, min_rate, cost_a, cost_b, exact_cost] (one host-to-device
    copy for both) and the final draw's uniforms ``u`` (num_blocks,), made
    in f64 on the host and cast to f32 by numpy, as the reference does.
    """

    def call_fused(self, runtimes: Dict[str, ScanRuntime], params, solve, scal, u):
        rt = self._runtime_args(runtimes, params)
        dev = self._device()
        solve = np.asarray(solve, np.float32).reshape(-1, 5)
        packed = torch.from_numpy(np.concatenate(
            [solve.ravel(), np.asarray(scal, np.float32)])).to(dev)
        rt["solve"] = packed[:solve.size].view(-1, 5)
        rt["scal"] = packed[solve.size:]
        rt["u"] = torch.from_numpy(np.asarray(u, np.float32)).to(dev)
        return self.fn(rt)


@dataclasses.dataclass
class CacheInfo:
    hits: int = 0
    misses: int = 0
    size: int = 0
    # the share of hits / misses above that were pilot lowerings
    pilot_hits: int = 0
    pilot_misses: int = 0
    # ... drain-group batch callables
    batched_hits: int = 0
    batched_misses: int = 0
    # ... and single-launch fused TAQA programs
    fused_hits: int = 0
    fused_misses: int = 0
    # staged-catalog serving counters (repro_torch.engine.staged), filled in
    # by Executor.compile_cache_info; zero for a bare compiler
    staged_hits: int = 0
    staged_misses: int = 0
    # local misses that adopted a build from a SharedBuildStore instead of
    # building (still counted in ``misses``: the local cache did miss)
    shared_hits: int = 0


class SharedBuildStore:
    """Builds shared between compilers, keyed by compile signature.

    Shards of one geometry give equal compile keys (keys hold block_rows,
    padded_rows, bucketed block counts, devices and column dtypes, never
    column data, which a callable reads from ``rt["catalog"]`` at call
    time).  So the shard compilers of a :class:`repro_torch.dist.
    DistExecutor` adopt each other's builds, each rebound to its own
    catalog: N same-geometry shards build each plan shape once.
    """

    def __init__(self):
        self._lock = threading.Lock()
        self._store: Dict[tuple, object] = {}

    def get(self, key):
        with self._lock:
            return self._store.get(key)

    def put(self, key, compiled) -> None:
        with self._lock:
            self._store.setdefault(key, compiled)


# key[0] -> the CacheInfo kind its hits and misses count under (plain query
# keys are the remainder)
_KEY_KIND = {"pilot": "pilot", "pilot_batched": "pilot",
             "batched": "batched", "fused": "fused"}


class PhysicalCompiler:
    """Lowers logical plans to compiled callables, with a signature cache."""

    def __init__(self, catalog: Dict[str, BlockTable],
                 shared_builds: Optional[SharedBuildStore] = None):
        self.catalog = catalog
        # consulted on a local miss before building, filled after a build
        self._shared = shared_builds
        # Values are compiled callables, or a pending Future while one thread
        # builds that key: drain workers compile concurrently, a key builds
        # once and counts one miss, and threads asking for it meanwhile wait
        # on the Future and count a hit, as in the reference.
        self._cache: Dict[tuple, object] = {}
        self._lock = threading.Lock()
        self.hits = 0
        self.misses = 0
        self.shared_hits = 0
        self._kind_hits = {"pilot": 0, "batched": 0, "fused": 0}
        self._kind_misses = {"pilot": 0, "batched": 0, "fused": 0}

    def cache_info(self) -> CacheInfo:
        with self._lock:
            size = sum(1 for v in self._cache.values()
                       if not isinstance(v, Future))
            return CacheInfo(self.hits, self.misses, size,
                             pilot_hits=self._kind_hits["pilot"],
                             pilot_misses=self._kind_misses["pilot"],
                             batched_hits=self._kind_hits["batched"],
                             batched_misses=self._kind_misses["batched"],
                             fused_hits=self._kind_hits["fused"],
                             fused_misses=self._kind_misses["fused"],
                             shared_hits=self.shared_hits)

    def _geometry_sig(self, needed) -> tuple:
        """The geometry of every table the plan scans: the gather route's
        shapes (a join's right side, a union's offsets) depend on all of
        them, not only on the sampled table's."""
        out = []
        for t in sorted(needed):
            tab = self.catalog[t]
            out.append((t, tab.block_rows, tab.padded_rows, tab.num_origin_blocks,
                        str(tab.device),
                        tuple((c, str(tab.columns[c].dtype)) for c in needed[t])))
        return tuple(out)

    def _lookup(self, key, build):
        kind = _KEY_KIND.get(key[0])
        with self._lock:
            entry = self._cache.get(key)
            if entry is None:  # this thread builds; others wait on the Future
                self.misses += 1
                if kind is not None:
                    self._kind_misses[kind] += 1
                placeholder: Future = Future()
                self._cache[key] = placeholder
            else:
                self.hits += 1
                if kind is not None:
                    self._kind_hits[kind] += 1
        if _trace.active() is not None:  # tag the enclosing stage span
            _trace.annotate_count(
                "compile_misses" if entry is None else "compile_hits")
            # a span attribute only: the key holds torch devices and dtypes,
            # so the hash is not the reference's
            _trace.annotate(compile_sig=_trace.sig_hash(key))
        if entry is None:
            try:
                proto = None if self._shared is None else self._shared.get(key)
                if proto is not None:
                    # adopt a same-geometry compiler's build, rebound to
                    # this compiler's catalog for its data
                    compiled = dataclasses.replace(proto, catalog=self.catalog)
                    with self._lock:
                        self.shared_hits += 1
                else:
                    compiled = build()
                    if self._shared is not None:
                        self._shared.put(key, compiled)
            except BaseException as e:
                with self._lock:  # let a later call retry the build
                    if self._cache.get(key) is placeholder:
                        del self._cache[key]
                placeholder.set_exception(e)
                raise
            with self._lock:
                self._cache[key] = compiled
            placeholder.set_result(compiled)
            return compiled
        if isinstance(entry, Future):
            return entry.result()  # waits for the build; re-raises its error
        return entry

    # -- final / plain queries ----------------------------------------------
    def query_signature(self, plan: L.Aggregate,
                        runtimes: Dict[str, ScanRuntime]) -> tuple:
        """The solo compile key of ``plan`` (constants hoisted), and the
        bucket key of the drain-group batch path: members that agree on it
        share one callable and may share one batched launch."""
        needed = _needed_by_table(plan, self.catalog)
        return ("query", plan_signature(plan, runtimes,
                                        self._geometry_sig(needed)))

    def compile_query(self, plan: L.Aggregate,
                      runtimes: Dict[str, ScanRuntime]) -> CompiledQuery:
        needed = _needed_by_table(plan, self.catalog)
        return self._lookup(self.query_signature(plan, runtimes),
                            lambda: self._build_query(
                                plan_template(plan), runtimes, needed))

    @staticmethod
    def _single_table(template, runtimes):
        """(table, method, predicates, channel exprs) of an ungrouped
        Aggregate(Filter*(Scan)) plan, or None for any other shape."""
        if template.max_groups != 1 or template.group_by is not None:
            return None
        if len(runtimes) != 1:
            return None
        (table, runtime), = runtimes.items()
        preds = _single_table_chain(template.child, table)
        if preds is None:
            return None
        exprs = tuple(None if a.op == "count" else a.expr for a in template.aggs)
        return table, runtime.method, preds, exprs

    def _kernel_lowering(self, template, runtimes, batched=False):
        """The kernel lowering of a plan's per-block stats, or None where its
        shape sends it elsewhere: the kernels take one block-sampled table,
        no GROUP BY, Filter*(Scan) and the channels they compute."""
        st = self._single_table(template, runtimes)
        if st is None or st[1] != "block":
            return None
        table, _, preds, exprs = st
        return self._lower_block_stats(table, preds, exprs, batched=batched)

    def _query_run(self, template, runtimes, needed):
        """The solo lowering of a (template) query plan: (run, route), where
        ``run(rt)`` gives (sums (num_channels, max_groups), counts
        (max_groups,))."""
        lowered = self._kernel_lowering(template, runtimes)
        if lowered is not None:
            stats_fn, route = lowered

            def run(rt):
                ch, cnt = stats_fn(rt)      # (n_phys, n_ch), (n_phys,)
                return ch.sum(dim=0)[:, None], cnt.sum()[None]

            return run, route
        st = self._single_table(template, runtimes)
        if st is not None and st[1] == "none":
            table, _, preds, exprs = st
            return self._exact_scan(table, preds, exprs), "torch_scan"
        return self._gather_run(template, runtimes, needed), "gather"

    def _build_query(self, template, runtimes, needed) -> CompiledQuery:
        run, route = self._query_run(template, runtimes, needed)
        return CompiledQuery(fn=run, catalog=self.catalog, needed=needed,
                             methods={t: r.method for t, r in runtimes.items()},
                             route=route)

    def _gather_run(self, template, runtimes, needed):
        """The gather route's body: trace the plan, then ONE segmented sum
        of every channel and of the row count per group."""
        methods = {t: r.method for t, r in runtimes.items()}
        exprs = tuple(None if a.op == "count" else a.expr for a in template.aggs)
        mg = template.max_groups
        tracer = _Tracer(needed, methods)

        def run(rt):
            tt = tracer.trace(template.child, rt)
            gid = _group_ids(tt.columns, tt.valid, template.group_by, mg)
            vals = channel_matrix(tt.columns, tt.valid, exprs, rt["params"])
            rows = torch.cat([vals, tt.valid.to(torch.float32)[None]])
            out = segment_sum(rows, gid, mg)
            return out[:-1], out[-1]

        return run

    # -- batched drain-group queries -----------------------------------------
    def compile_batched_query(self, plan: L.Aggregate,
                              runtimes: Dict[str, ScanRuntime],
                              batch: int) -> CompiledBatch:
        """One callable running ``batch`` members of ``plan``'s
        :meth:`query_signature` per call.  Callers split buckets into powers
        of two, so batch sizes recur in log-many values."""
        if batch < 1:
            raise ValueError(f"batch must be >= 1, got {batch}")
        needed = _needed_by_table(plan, self.catalog)
        key = ("batched", batch,
               plan_signature(plan, runtimes, self._geometry_sig(needed)))
        return self._lookup(key, lambda: self._build_batched(
            plan_template(plan), runtimes, needed, batch))

    def _build_batched(self, template, runtimes, needed, batch) -> CompiledBatch:
        """A plan whose solo route is a kernel takes the batched kernel (one
        launch over B id rows); any other runs each lane through its solo
        body, in lane order."""
        methods = {t: r.method for t, r in runtimes.items()}
        lowered = self._kernel_lowering(template, runtimes, batched=True)
        if lowered is not None:
            lanes_fn, route = lowered

            def run_batched(rt):
                # each lane: the solo route's (n_phys, n_ch) channel tensor
                # and (n_phys,) count, built fresh by the solo route's own
                # calls, and the solo route's own reductions over them — one
                # reduction over a (B, n_phys, n_ch) tensor may split its sum
                # in another order
                lanes = lanes_fn(rt)
                sums = torch.stack([ch.sum(dim=0) for ch, _ in lanes])
                counts = torch.stack([cnt.sum() for _, cnt in lanes])
                return sums[:, :, None], counts[:, None]
        else:
            run, solo_route = self._query_run(template, runtimes, needed)
            route = f"{solo_route}_batched"

            def run_batched(rt):
                lanes = _lanes(run, rt, batch)
                return (torch.stack([s for s, _ in lanes]),
                        torch.stack([c for _, c in lanes]))

        return CompiledBatch(fn=run_batched, catalog=self.catalog,
                             needed=needed, methods=methods, route=route,
                             batch=batch)

    def _exact_scan(self, table: str, preds: List[Expr],
                    exprs: Sequence[Optional[Expr]]):
        """The unsampled ungrouped scan: predicates and channels evaluated
        over whole columns in f32 against the device params vector, then
        one ``torch.sum`` per channel."""
        def run(rt):
            params = rt["params"]
            tab = rt["catalog"][table]  # the registered table at call time
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
        needed = _needed_by_table(plan, self.catalog)
        key = ("pilot", pilot_table, pair_table,
               plan_signature(plan, {pilot_table: runtime},
                              self._geometry_sig(needed)))
        return self._lookup(key, lambda: self._build_pilot(
            plan_template(plan), pilot_table, runtime.n_phys, pair_table,
            needed))

    @staticmethod
    def _has_pair(plan, pair_table: Optional[str]) -> bool:
        """Whether a join of ``plan`` has ``pair_table`` alone on its right:
        the shape whose pilot also gives per-block-pair sums."""
        return pair_table is not None and any(
            isinstance(p, L.Join) and [s.table for s in p.right.scans()] == [pair_table]
            for p in _walk(plan))

    def _pilot_kernel(self, plan, pilot_table, pair_table, batched=False):
        """The kernel lowering of a pilot, or None: the kernels take a pilot
        with one group and no pair statistics over Filter*(Scan)."""
        if plan.max_groups != 1 or self._has_pair(plan, pair_table):
            return None
        preds = _single_table_chain(plan.child, pilot_table)
        if preds is None:
            return None
        # one channel per simple aggregate plus the trailing "__rows" channel
        exprs = tuple([None if a.op == "count" else a.expr for a in plan.aggs] + [None])
        return self._lower_block_stats(pilot_table, preds, exprs, batched=batched)

    @staticmethod
    def _kernel_pilot_outputs(ch: torch.Tensor):
        """A kernel-route pilot's (block_sums (n_phys, 1, n_ch), present
        (1,)) from its (n_phys, n_ch) channel tensor."""
        return ch[:, None, :], (ch[:, -1].sum() > 0)[None]

    def _build_pilot(self, plan, pilot_table, n_phys, pair_table,
                     needed) -> CompiledPilot:
        methods = {pilot_table: "block"}
        lowered = self._pilot_kernel(plan, pilot_table, pair_table)
        if lowered is not None:
            stats_fn, route = lowered

            def run(rt):
                ch, _ = stats_fn(rt)               # (n_phys, n_ch)
                return (*self._kernel_pilot_outputs(ch), None)

            return CompiledPilot(fn=run, catalog=self.catalog, needed=needed,
                                 methods=methods, route=route)
        run = self._pilot_tracer_run(plan, pilot_table, n_phys, pair_table,
                                     needed)
        return CompiledPilot(fn=run, catalog=self.catalog, needed=needed,
                             methods=methods, route="gather")

    def _pilot_lane(self, plan, pilot_table, n_phys, pair_table, needed):
        """The gather-route pilot's per-row work: rt -> (traced, vals (n_ch,
        rows) f32, keys (rows,) int64), each row's key its (pilot block,
        group) segment ``pblock * max_groups + group``."""
        mg = plan.max_groups
        exprs = tuple([None if a.op == "count" else a.expr for a in plan.aggs] + [None])
        tracer = _Tracer(needed, {pilot_table: "block"},
                         pilot_table=pilot_table, n_phys_pilot=n_phys,
                         pair_table=pair_table)

        def lane(rt):
            tt = tracer.trace(plan.child, rt)
            gid = _group_ids(tt.columns, tt.valid, plan.group_by, mg)
            vals = channel_matrix(tt.columns, tt.valid, exprs, rt["params"])
            return tt, vals, tt.pblock * mg + gid

        return lane

    def _pilot_tracer_run(self, plan, pilot_table, n_phys, pair_table, needed):
        """The gather-route pilot body: rt -> (block_sums, present, pair).

        One segmented sum gives every channel's sum per (pilot block,
        group), over ``n_phys * max_groups`` segments; rows that belong to
        no pilot block (another table's, on the pilot table's right or in a
        union) carry the scratch block n_phys, so their keys lie past the
        last segment and ``segment_sum`` drops them.  With a pair table a
        second one gives the sums per (pilot block, right block), the
        reference's dense layout.  Where the pilot table's rows come first
        and it is scanned once (:func:`_pilot_rows_first`), a pilot block's
        rows are its ``block_rows`` contiguous rows, and both calls state so
        (the slab claim: key // W == row // block_rows).
        """
        mg = plan.max_groups
        has_pair = self._has_pair(plan, pair_table)
        lane = self._pilot_lane(plan, pilot_table, n_phys, pair_table, needed)
        n_right = self.catalog[pair_table].num_blocks if has_pair else 0
        rcol = f"__rblock_{pair_table}"
        slab = _pilot_rows_first(plan.child, pilot_table)

        def run(rt):
            tt, vals, keys = lane(rt)
            claim = lambda width: (dict(slab_rows=tt.block_rows, slab_keys=width)
                                   if slab else {})
            dense = segment_sum(vals, keys, n_phys * mg, **claim(mg))
            block_sums = dense.reshape(vals.shape[0], n_phys, mg).permute(1, 2, 0)
            present = block_sums[:, :, -1].sum(dim=0) > 0
            pair = None
            if has_pair:
                rb = torch.where(tt.valid, tt.columns[rcol], 0)
                pdense = segment_sum(vals, tt.pblock * n_right + rb, n_phys * n_right,
                                     **claim(n_right))
                pair = pdense.reshape(vals.shape[0], n_phys, n_right).permute(1, 2, 0)
            return block_sums, present, pair

        return run

    # -- stacked pilots (shared-pilot drain groups) ---------------------------
    def pilot_stacks(self, plan: L.Aggregate, pilot_table: str) -> bool:
        """Whether B same-signature pilots of ``plan`` (with no pair table)
        stack into one call of :meth:`compile_batched_pilot`: its kernel
        route does, and so does its gather route where the trace's rows are
        the pilot table's sampled rows and nothing else (``n_phys ·
        block_rows`` of them, every one in a pilot block), which keeps the
        slab claim true across the lanes' concatenated rows.  Anything else
        (a union, the pilot table on a join's right) runs solo."""
        template = plan_template(plan)
        return (self._pilot_kernel(template, pilot_table, None) is not None
                or _row_tables(template.child) == [pilot_table])

    def compile_batched_pilot(self, plan: L.Aggregate, pilot_table: str,
                              runtime: ScanRuntime,
                              batch: int) -> CompiledPilotBatch:
        """One callable running ``batch`` same-signature pilot scans per
        call (:class:`CompiledPilotBatch`), keyed as the reference keys its
        batched pilot.  Callers gate on :meth:`pilot_stacks`; pair-table
        pilots stay solo."""
        if batch < 2:
            raise ValueError(f"batch must be >= 2, got {batch}")
        if not self.pilot_stacks(plan, pilot_table):
            raise ValueError(f"pilots of this plan over {pilot_table!r} do not stack")
        needed = _needed_by_table(plan, self.catalog)
        key = ("pilot_batched", batch, pilot_table,
               plan_signature(plan, {pilot_table: runtime},
                              self._geometry_sig(needed)))
        return self._lookup(key, lambda: self._build_batched_pilot(
            plan_template(plan), pilot_table, runtime.n_phys, needed, batch))

    def _build_batched_pilot(self, plan, pilot_table, n_phys, needed,
                             batch) -> CompiledPilotBatch:
        methods = {pilot_table: "block"}
        lowered = self._pilot_kernel(plan, pilot_table, None, batched=True)
        if lowered is not None:
            lanes_fn, route = lowered

            def run(rt):
                # each lane's (n_phys, n_ch) channel tensor from the batched
                # launches, then the solo pilot's own outputs of it
                outs = [self._kernel_pilot_outputs(ch) for ch, _ in lanes_fn(rt)]
                return (torch.stack([bs for bs, _ in outs]),
                        torch.stack([p for _, p in outs]))

            return CompiledPilotBatch(fn=run, catalog=self.catalog, needed=needed,
                                      methods=methods, route=route, batch=batch)

        mg = plan.max_groups
        width = n_phys * mg                # one lane's segments
        lane = self._pilot_lane(plan, pilot_table, n_phys, None, needed)

        def run(rt):
            vals, keys = [], []
            for member in _lane_runtimes(rt, batch):
                tt, v, k = lane(member)
                vals.append(v)
                keys.append(k)
            # each lane traced n_phys * block_rows rows (pilot_stacks), so
            # lane b's rows start at row b * n_phys * block_rows and its keys
            # at b * width: key // max_groups == row // block_rows holds
            # across the lanes, and the slab route sums each pilot block of
            # its rows alone, as each lane's solo call does
            dense = segment_sum(torch.cat(vals, dim=1), stack_lane_keys(keys, width),
                                batch * width, slab_rows=tt.block_rows, slab_keys=mg)
            block_sums = dense.reshape(-1, batch, n_phys, mg).permute(1, 2, 3, 0)
            return block_sums, block_sums[..., -1].sum(dim=1) > 0

        return CompiledPilotBatch(fn=run, catalog=self.catalog, needed=needed,
                                  methods=methods, route="gather_stacked", batch=batch)

    # -- fused single-launch TAQA ---------------------------------------------
    def compile_fused(self, plan: L.Aggregate, pilot_table: str,
                      runtimes: Dict[str, ScanRuntime],
                      solve_channels: Tuple[int, ...]) -> CompiledFused:
        """The single-launch TAQA program: pilot scan -> BSAP rate solve ->
        final sampled aggregation in one call.  Callers gate it to the
        ungrouped, pair-free, unsharded shape; the rate solve on the device
        is ADVISORY (f32): the host re-solves in f64 and verifies the
        device's final draw before trusting its sums (see
        ``core.taqa.PilotDB.run_fused``)."""
        needed = _needed_by_table(plan, self.catalog)
        num_blocks = self.catalog[pilot_table].num_blocks
        key = ("fused", pilot_table, tuple(solve_channels), num_blocks,
               plan_signature(plan, runtimes, self._geometry_sig(needed)))
        return self._lookup(key, lambda: self._build_fused(
            plan_template(plan), pilot_table, runtimes, needed,
            tuple(solve_channels), num_blocks))

    def _build_fused(self, template, pilot_table, runtimes, needed,
                     solve_channels, num_blocks) -> CompiledFused:
        """The solo pilot body (the column kernels where the plan takes
        them), then ``taqa_solve_rate`` and ``taqa_draw_compact`` on the
        pilot's device outputs, then the solo final body.

        Unlike the reference's one XLA program, the host reads (nsel,
        flags), 8 bytes, before the final: the final then runs the solo
        callable at the solo path's bucket (``ids = padded[:bucket]``,
        ``n_real = nsel``), the same shapes and the same reductions as a
        two-stage final on the same draw, so its sums are that final's bits
        by construction.  A final of another padded length would sum in
        another order; a padding-invariant final reduction would remove the
        read.  With nsel 0 the final is skipped: the caller then takes the
        two-stage path's exact or solo route anyway."""
        methods = {t: r.method for t, r in runtimes.items()}
        buckets = fused_buckets(num_blocks)
        pilot_run = self._build_pilot(template, pilot_table,
                                      runtimes[pilot_table].n_phys, None, needed).fn
        final_run, route = self._query_run(template, runtimes, needed)
        ch_idx = torch.tensor(solve_channels, dtype=torch.int32,
                              device=self.catalog[pilot_table].device)

        def run(rt):
            bs, present, _ = pilot_run(rt)   # (n_phys_p, 1, n_ch), (1,)
            theta, flags = taqa_solve_rate(bs[:, 0, :].contiguous(), present,
                                           rt["nreal"][pilot_table], ch_idx,
                                           rt["solve"], rt["scal"])
            nsel_d, padded = taqa_draw_compact(rt["u"], theta[1:])
            # the program's one host read before the final
            nsel, flag_bits = torch.cat((nsel_d, flags)).tolist()
            sums = counts = None
            if nsel > 0:
                b = buckets[sum(nsel > x for x in buckets[:-1])]
                frt = dict(rt, ids={**rt["ids"], pilot_table: padded[:b]},
                           nreal={**rt["nreal"], pilot_table: nsel})
                sums, counts = final_run(frt)
            return bs, present, theta, flag_bits, nsel, padded, sums, counts

        return CompiledFused(fn=run, catalog=self.catalog, needed=needed,
                             methods=methods, route=f"fused_{route}")

    # -- kernel lowering of per-block stats ----------------------------------
    def _lower_block_stats(self, table: str, preds: List[Expr],
                           exprs: Sequence[Optional[Expr]], batched=False):
        """Lower Filter*(Scan) per-block channel stats onto the kernels.

        Returns (stats_fn, route), or None when the shape doesn't fit a
        kernel.  Solo, ``stats_fn(rt)`` yields ``(channel_sums (n_phys,
        n_ch), counts (n_phys,))`` with padding rows (beyond n_real) zeroed.
        ``batched=True`` takes ``rt["ids"][table]`` (B, n_phys),
        ``rt["nreal"][table]`` a list of B counts and ``rt["params"]``
        (B, P), makes ONE batched launch per distinct channel column, and
        yields per lane exactly the solo pair; each lane's bounds come from
        the solo ``_bounds_vector`` on its params row, so the f32 bound bits
        are the solo ones.  The kernels read the table's columns in their
        stored dtypes; no column is cast, padded or materialised per call.
        The table is looked up when the callable runs, not when it is built:
        a replacement of the same geometry (same cache key) must be read,
        not the old data.
        """
        br = self.catalog[table].block_rows   # geometry: part of the cache key
        if batched:
            fa, ba, channels = filtered_agg_batched, block_agg_batched, _lane_channels
        else:
            fa, ba, channels = filtered_agg, block_agg, _kernel_channels
        suffix = "_batched" if batched else ""
        if preds:
            q6 = _match_q6_bounds(preds)
            specs = _match_channels(exprs, products=True)
            if q6 is None or specs is None:
                return None
            (f1, f2, f3), slots = q6

            def bounds_of(params):
                if not batched:
                    return _bounds_vector(slots, params)
                return torch.stack([_bounds_vector(slots, params[b])
                                    for b in range(params.shape[0])])

            def stats_fn(rt):
                tab = rt["catalog"][table]  # the registered table at call time
                cols = tab.columns
                ids = rt["ids"][table]
                bounds = bounds_of(rt["params"])
                outs = {}
                for spec in specs:
                    if spec[0] != "prod" or spec[1:] in outs:
                        continue
                    y = None if spec[2] is None else cols[spec[2]]
                    outs[spec[1:]] = fa(cols[spec[1]], y, cols[f1], cols[f2],
                                        cols[f3], tab.valid, br, ids, bounds)
                if not outs:  # COUNT-only query: any column works for cnt
                    c0 = cols[f1]
                    outs[None] = fa(c0, c0, cols[f1], cols[f2], cols[f3],
                                    tab.valid, br, ids, bounds)
                return channels(outs, specs, rt["nreal"][table])

            return stats_fn, "filtered_agg" + suffix

        specs = _match_channels(exprs, products=False)
        if specs is None:
            return None

        def stats_fn(rt):
            tab = rt["catalog"][table]  # the registered table at call time
            cols = tab.columns
            ids = rt["ids"][table]
            outs = {}
            for spec in specs:
                if spec[0] == "prod" and spec[1:] not in outs:
                    outs[spec[1:]] = ba(cols[spec[1]], tab.valid, br, ids)
            if not outs:  # COUNT-only: the cnt lane ignores the value column
                outs[None] = ba(tab.valid, tab.valid, br, ids)
            return channels(outs, specs, rt["nreal"][table])

        return stats_fn, "block_agg" + suffix


def _kernel_channels(outs: dict, specs, n_real: int):
    """The (n_phys, n_ch) channel tensor and (n_phys,) counts of one scan
    from its kernel outputs (keyed by channel spec; column 0 is the count,
    column 1 the sum), padding rows zeroed."""
    cnt = next(iter(outs.values()))[:, 0]
    chans = [cnt if s[0] == "count" else outs[s[1:]][:, 1] for s in specs]
    return _mask_padding(torch.stack(chans, dim=1), cnt, n_real)


def _lane_channels(outs: dict, specs, n_reals: Sequence[int]):
    """:func:`_kernel_channels` of each lane of batched kernel outputs
    ((B, n_phys, k) each): per lane the solo call on that lane's slices."""
    return [_kernel_channels({k: v[b] for k, v in outs.items()}, specs, n)
            for b, n in enumerate(n_reals)]


def _mask_padding(chans: torch.Tensor, cnt: torch.Tensor, n_real):
    """Set the rows of padding ids (positions >= n_real) to +0.0.  They read
    block 0 of the table, or position 0 of a staged rung: a select (not the
    reference's multiply by a 0/1 mask, whose zero takes the sign of what
    the padding read) makes them the same bits whatever they read.
    ``n_real`` is a host int or a device scalar."""
    n_phys = chans.shape[0]
    real = torch.arange(n_phys, device=chans.device) < n_real
    zero = torch.zeros((), dtype=chans.dtype, device=chans.device)
    return torch.where(real[:, None], chans, zero), torch.where(real, cnt, zero)


def _row_tables(plan: L.Plan) -> List[str]:
    """The tables whose rows a traced plan's rows are, in row order: a
    filter keeps its child's rows, a join its left side's, a union
    concatenates its inputs'."""
    if isinstance(plan, L.Scan):
        return [plan.table]
    if isinstance(plan, L.Filter):
        return _row_tables(plan.child)
    if isinstance(plan, L.Join):
        return _row_tables(plan.left)
    if isinstance(plan, L.Union):
        return [t for p in plan.inputs for t in _row_tables(p)]
    raise TypeError(plan)


def _pilot_rows_first(plan: L.Plan, pilot_table: str) -> bool:
    """Whether the pilot table's sampled rows are the traced plan's first
    rows and its only rows with a pilot block: its scan comes first in row
    order and no other scan of it adds rows.  Then row r of the trace lies
    in pilot block r // block_rows, or in none."""
    tables = _row_tables(plan)
    return tables[0] == pilot_table and tables.count(pilot_table) == 1


def _walk(plan: L.Plan):
    yield plan
    if isinstance(plan, L.Aggregate):
        yield from _walk(plan.child)
    else:
        for c in plan.children():
            yield from _walk(c)
