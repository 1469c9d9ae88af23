"""Plan executor.

Executes logical plans through the compiled physical layer
(:mod:`repro_torch.engine.physical`): block-sampled single-table scans route
through the hand-written column kernels, exact single-table ungrouped scans
through one pass of plain tensor ops, and everything else (GROUP BY, joins,
unions, row sampling, predicates or channels the kernels cannot take)
through the gather route and its segmented-sum kernel; repeated
structurally-identical queries hit the signature cache.  The scan cost
(bytes moved) is attributed by that layer: block-sampled scans pay only for
sampled slabs, row-sampled and exact scans stream everything.

Besides plain execution it produces the artifacts TAQA's pilot needs
(``execute_pilot``: per-block sums of every simple aggregate and, for a
join's pair table, per-block-pair sums), stacks a drain group's
same-signature pilots (``execute_pilots_batched``: one call, one host copy),
and runs a drain group's finals in batches (``execute_batch``: members that
share a compile key run as one batched call).  A sampled scan that draws
zero blocks or rows raises :class:`EmptySampleError` instead of fabricating
an upscale factor — callers take their exact fallback.

Each query (each batch) crosses the device→host boundary once, where its
sums are widened to f64 for the host-side upscale and rate solve.

Tables opted in through :meth:`Executor.register_staged` serve covered
block-sampled scans from pre-gathered rungs (:mod:`repro_torch.engine.staged`):
the same routes — column kernels and gather route alike — over the rung's
tensors, with block positions in place of block ids, bitwise the fresh draw
under the table's pinned staging seed.

``execute_fused`` runs TAQA's single-launch program (pilot, f32 rate solve,
final draw and final scan) for :meth:`repro_torch.core.taqa.PilotDB.run_fused`.

The eager interpreter (``use_compiled=False``) is the in-package oracle:
it runs the plan operator by operator over materialized tables
(:mod:`repro_torch.engine.ops`), with the same host draws.
"""

from __future__ import annotations

import dataclasses
import threading
import time
from typing import Callable, Dict, List, Optional, Tuple

import numpy as np
import torch

from repro_torch.device import resolve_device
from repro_torch.engine import logical as L
from repro_torch.engine import ops
from repro_torch.engine.physical import (PhysicalCompiler, ScanRuntime,
                                         SharedBuildStore,
                                         plan_constants, scan_cost_bytes)
from repro_torch.engine.sampling import (SampleInfo, block_sample, draw_block_ids,
                                         draw_row_sample, pad_block_ids, row_sample)
from repro_torch.engine.staged import (DEFAULT_STAGED_RATES, SampleCatalog,
                                       build_ladder, prepare_mono_subdraw)
from repro_torch.engine.table import BlockTable
from repro_torch.obs import trace as _trace


class EmptySampleError(RuntimeError):
    """A sampled scan produced zero sampled units (blocks or rows).

    No unbiased upscale exists for an empty sample; the executor surfaces
    the condition so the caller can fall back to exact execution.
    """

    def __init__(self, table: str, method: str, rate: float):
        self.table = table
        self.method = method
        self.rate = rate
        super().__init__(
            f"sampled scan of {table!r} ({method}, rate={rate}) drew 0 units")


@dataclasses.dataclass
class QueryResult:
    agg_names: List[str]
    values: np.ndarray           # (num_aggs, max_groups) float64, upscaled
    raw_sums: np.ndarray         # (num_aggs, max_groups) unscaled sample sums
    group_counts: np.ndarray     # (max_groups,) raw surviving row counts
    group_present: np.ndarray    # (max_groups,) bool
    scanned_bytes: int
    sample_infos: Dict[str, SampleInfo]
    wall_time_s: float

    def scalar(self, name: str, group: int = 0) -> float:
        return float(self.values[self.agg_names.index(name), group])


@dataclasses.dataclass
class PilotStats:
    """Per-block statistics from the pilot query (§3.1, §3.3).

    block_sums: (n_p, max_groups, num_aggs) — sum of each simple aggregate's
        expression within each sampled origin block of the pilot table.
    pair_sums: optional {right_table: (n_p, N_right, num_aggs)} for Lemma 4.8.
    """

    table: str
    theta_p: float
    n_sampled_blocks: int
    n_total_blocks: int
    block_rows: int
    agg_names: List[str]
    block_sums: np.ndarray
    group_present: np.ndarray
    pair_sums: Dict[str, np.ndarray]
    right_total_blocks: Dict[str, int]
    scanned_bytes: int
    wall_time_s: float


class Executor:
    def __init__(self, catalog: Dict[str, BlockTable], *, device="cuda",
                 use_compiled: bool = True, staged_bytes: Optional[int] = None,
                 shared_builds: Optional[SharedBuildStore] = None):
        self.device = resolve_device(device)
        # False: the eager interpreter, the in-package oracle (no staging,
        # no batching, no fused program)
        self.use_compiled = use_compiled
        # Pre-staged block-sample ladders (repro_torch.engine.staged): tables
        # opted in via register_staged() serve covered sampled scans from
        # materialized rungs; staged_bytes bounds rung residency.
        self.staged = SampleCatalog(max_bytes=staged_bytes)
        self.catalog: Dict[str, BlockTable] = {}
        for name, table in catalog.items():
            self.register_table(name, table)
        # shared_builds: builds shared with other executors' compilers of
        # the same geometry (a DistExecutor's shards)
        self.physical = PhysicalCompiler(self.catalog, shared_builds=shared_builds)
        # pilots_run counts pilot STAGES (incremented by PilotDB.run_pilot,
        # once per stage regardless of undershoot retries); queries_run
        # counts execute() calls; device_dispatches counts compiled-callable
        # invocations.
        self._counter_lock = threading.Lock()
        self.pilots_run = 0
        self.queries_run = 0
        self.device_dispatches = 0

    def _count(self, attr: str) -> None:
        with self._counter_lock:
            setattr(self, attr, getattr(self, attr) + 1)

    # -- catalog management ---------------------------------------------------
    def register_table(self, name: str, table: BlockTable) -> None:
        """Add (or replace) a catalog table; it must live on this executor's
        device.  The compiler shares this dict, and column data enters
        compiled callables at call time, so no cache needs invalidating."""
        dev = table.device
        if dev.type != self.device.type or self.device.index not in (None, dev.index):
            raise ValueError(f"table {name!r} is on {table.device}, the "
                             f"executor on {self.device}")
        self.catalog[name] = table
        # Staged lifecycle: the replaced table's ladder holds stale gathered
        # slabs — drop it (re-staging is the registrant's call); other
        # ladders replicate this table in their rung-compiler catalogs and
        # must see the new tensors.
        self.staged.invalidate(name)
        self.staged.refresh_replicated(name, table)

    def register_staged(self, name: str, rates=DEFAULT_STAGED_RATES, *,
                        seed: int = 0) -> None:
        """Materialize a staged sample ladder for catalog table ``name``.

        ``seed`` pins the table's one staging realization: EVERY block draw
        of the table (staged hit or fresh miss, pilot or final) replays it,
        which is what makes staged and fresh answers bit-identical.  The
        eager executor has no physical layer to serve rungs through, so
        staging is a no-op there.
        """
        if name not in self.catalog:
            raise KeyError(f"unknown table {name!r}")
        if not self.use_compiled:
            return
        self.staged.admit(build_ladder(name, self.catalog[name], rates, seed,
                                       self.catalog))

    # -- table metadata (the "DBMS statistics" TAQA consults) ---------------
    def table_rows(self, name: str) -> int:
        return self.catalog[name].num_rows

    def table_blocks(self, name: str) -> int:
        return self.catalog[name].num_blocks

    def block_rows(self, name: str) -> int:
        return self.catalog[name].block_rows

    def is_sharded(self, name: str) -> bool:
        """Whether ``name`` executes as sharded sub-scans (DistExecutor
        overrides).  A monolithic executor never shards."""
        return False

    def table_bytes(self, name: str) -> int:
        return self.catalog[name].total_bytes()

    def compile_cache_info(self):
        """Hit/miss/size counters of the physical-plan signature cache,
        every staged rung's compiler included in the totals, plus the
        staged-route hit/miss counters."""
        info = self.physical.cache_info()
        rung_hits, rung_misses, rung_size = self.staged.compile_totals()
        info.hits += rung_hits
        info.misses += rung_misses
        info.size += rung_size
        info.staged_hits = self.staged.hits
        info.staged_misses = self.staged.misses
        return info

    def staged_info(self) -> Dict[str, object]:
        """Staged-catalog serving counters and per-table ladder state."""
        return self.staged.info()

    # -- host-side sampling decisions ---------------------------------------
    def _scan_runtimes(
        self, plan: L.Plan, exclude: Optional[str] = None,
    ) -> Tuple[Dict[str, ScanRuntime], Dict[str, SampleInfo]]:
        """Draw every scan's TABLESAMPLE decision (host RNG, as a DBMS picks
        pages before scanning) and package it as compiled-callable inputs —
        the reference's draw bit for bit.  A table with a staged ladder
        draws from its pinned staging seed (hits and misses agree bitwise);
        ``exclude`` skips the one table whose runtime the staged route
        supplies itself."""
        runtimes: Dict[str, ScanRuntime] = {}
        infos: Dict[str, SampleInfo] = {}
        for s in plan.scans():
            if s.table == exclude:
                continue
            table = self.catalog[s.table]
            if s.sample is None:
                runtimes[s.table] = ScanRuntime("none")
                infos[s.table] = SampleInfo(
                    "none", 1.0, 0, table.num_blocks, table.num_blocks,
                    np.arange(table.num_blocks),
                    scanned_bytes=scan_cost_bytes(table, "none"))
            elif s.sample.method == "block":
                lad = self.staged.ladder(s.table)
                seed = s.sample.seed if lad is None else lad.seed
                if lad is not None and s.sample.rate < 1.0:
                    # a ladder-bearing table drawn fresh: rate uncovered,
                    # rung tensors evicted, or a plan the staged route
                    # does not take
                    self.staged.note_miss()
                ids = draw_block_ids(table.num_blocks, s.sample.rate, seed)
                phys, n_real, n_phys = pad_block_ids(ids, table.num_blocks)
                runtimes[s.table] = ScanRuntime("block", n_real, n_phys, phys)
                infos[s.table] = SampleInfo(
                    "block", s.sample.rate, seed, n_real,
                    table.num_blocks, ids,
                    scanned_bytes=scan_cost_bytes(table, "block", n_real))
            else:
                keep, infos[s.table] = draw_row_sample(
                    table, s.sample.rate, s.sample.seed)
                runtimes[s.table] = ScanRuntime("row", keep_mask=keep)
        return runtimes, infos

    @staticmethod
    def _check_empty(infos: Dict[str, SampleInfo]) -> None:
        for name, info in infos.items():
            if info.rate >= 1.0:
                continue
            if info.method == "block" and not info.n_sampled_blocks:
                raise EmptySampleError(name, "block", info.rate)
            if info.method == "row" and not info.n_sampled_rows:
                raise EmptySampleError(name, "row", info.rate)

    @staticmethod
    def _upscale(infos: Dict[str, SampleInfo]) -> float:
        """Upscaling (§3.3 final rewriting step 2).  With exactly one sampled
        table we use the Hájek scale N/n (conditional-SRS estimator matching
        BSAP's Lemma-B.1 bounds); with two or more we use Horvitz–Thompson
        1/∏θ (matching Lemma 4.8's variance expansion).  AVG is the ratio of
        two upscaled sums, so the scale cancels either way.  Empty samples
        raise EmptySampleError before this point — no fabricated scales.
        """
        sampled = [i for i in infos.values()
                   if i.method in ("block", "row") and i.rate < 1.0]
        if len(sampled) == 1:
            info = sampled[0]
            if info.method == "block":
                return info.n_total_blocks / info.n_sampled_blocks
            n = info.n_sampled_rows
            return (info.n_total_rows or n) / n
        scale = 1.0
        for info in sampled:
            scale /= info.rate
        return scale

    @staticmethod
    def _compose_values(plan: L.Aggregate, sums: np.ndarray, counts: np.ndarray,
                        scale: float) -> np.ndarray:
        values = np.zeros_like(sums)
        for i, a in enumerate(plan.aggs):
            if a.op in ("sum", "count"):
                values[i] = sums[i] * scale
            elif a.op == "avg":
                with np.errstate(invalid="ignore", divide="ignore"):
                    values[i] = np.where(counts > 0,
                                         sums[i] / np.maximum(counts, 1), np.nan)
        return values

    # -- eager relational execution (the oracle) ----------------------------
    def _run_relational(self, plan: L.Plan, infos: Dict[str, SampleInfo],
                        pair_for: Optional[Tuple[str, str]] = None) -> BlockTable:
        if isinstance(plan, L.Scan):
            table = self.catalog[plan.table]
            if plan.sample is None:
                infos[plan.table] = SampleInfo(
                    "none", 1.0, 0, table.num_blocks, table.num_blocks,
                    np.arange(table.num_blocks),
                    scanned_bytes=table.total_bytes())
                return table
            sample = block_sample if plan.sample.method == "block" else row_sample
            sampled, infos[plan.table] = sample(table, plan.sample.rate,
                                                plan.sample.seed)
            return sampled
        if isinstance(plan, L.Filter):
            return ops.filter_table(self._run_relational(plan.child, infos, pair_for),
                                    plan.pred)
        if isinstance(plan, L.Join):
            left = self._run_relational(plan.left, infos, pair_for)
            right = self._run_relational(plan.right, infos, pair_for)
            rscans = plan.right.scans()
            rblock_col = None
            if (pair_for is not None and len(rscans) == 1
                    and rscans[0].table == pair_for[1]):
                rblock_col = f"__rblock_{pair_for[1]}"
            return ops.join_unique(left, right, plan.left_key, plan.right_key,
                                   rblock_col=rblock_col)
        if isinstance(plan, L.Union):
            return ops.union_all(
                [self._run_relational(p, infos, pair_for) for p in plan.inputs])
        raise TypeError(plan)

    def _execute_eager(self, plan: L.Aggregate) -> QueryResult:
        t0 = time.perf_counter()
        infos: Dict[str, SampleInfo] = {}
        table = self._run_relational(plan.child, infos)
        # every channel and, last, the row count: one segmented sum
        exprs = [None if a.op == "count" else a.expr for a in plan.aggs] + [None]
        out = ops.grouped_sums(table, exprs, plan.group_by, plan.max_groups)
        out = out.double().cpu().numpy()
        sums, counts = out[:-1], out[-1]
        self._check_empty(infos)
        values = self._compose_values(plan, sums, counts, self._upscale(infos))
        return QueryResult(
            agg_names=[a.name for a in plan.aggs],
            values=values,
            raw_sums=sums,
            group_counts=counts,
            group_present=counts > 0,
            scanned_bytes=sum(i.scanned_bytes for i in infos.values()),
            sample_infos=infos,
            wall_time_s=time.perf_counter() - t0,
        )

    # -- public API ----------------------------------------------------------
    def execute(self, plan: L.Aggregate) -> QueryResult:
        self._count("queries_run")
        # the span ends after the query's host read, so its time is the
        # device's too (no synchronization is added for it)
        with _trace.span("scan") as sp:
            res = (self._execute_compiled(plan) if self.use_compiled
                   else self._execute_eager(plan))
            sp.set(scanned_bytes=res.scanned_bytes)
        return res

    def _execute_compiled(self, plan: L.Aggregate) -> QueryResult:
        route = self._staged_route(plan)
        if route is not None:
            result = self._execute_staged(plan, *route)
            if result is not None:
                return result
        t0 = time.perf_counter()
        runtimes, infos = self._scan_runtimes(plan)
        self._check_empty(infos)
        return self._execute_drawn(plan, runtimes, infos, t0, self.physical)

    def _staged_route(self, plan: L.Aggregate):
        """(table, SampleClause, ladder, rung) when ``plan`` can run against
        a monolithic staged rung, else None (the fresh path — which still
        draws under the ladder seed, so both routes agree bitwise).

        Exactly one block-sampled (rate < 1) scan, whose table holds a
        resident monolithic rung covering the rate.  Unlike the reference,
        which stages only on its XLA route, every route takes rungs: the
        column kernels and the gather route read the rung's tensors at
        block positions, with the fresh ``n_phys``.
        """
        sampled = [s for s in plan.scans()
                   if s.sample is not None and s.sample.rate < 1.0]
        if len(sampled) != 1 or sampled[0].sample.method != "block":
            return None
        target = sampled[0]
        lad = self.staged.ladder(target.table)
        if lad is None or lad.sharded is not None:
            return None
        rung = lad.rung_for(target.sample.rate)
        if rung is None:
            return None
        return target.table, target.sample, lad, rung

    def _execute_staged(self, plan: L.Aggregate, table: str, sample,
                        lad, rung) -> Optional[QueryResult]:
        """Execute against a staged rung: the memoized sub-draw (a
        restriction of the ladder's one realization), block POSITIONS within
        the rung in place of block ids, and the rung's own compiler, with
        the physical block count forced to the fresh path's value: the same
        rows, shapes and reduction order as a fresh draw, so the answer is
        bitwise the fresh one.  None when the budget dropped the rung after
        :meth:`_staged_route` chose it: the caller then draws fresh."""
        t0 = time.perf_counter()
        origin = self.catalog[table]
        sub = prepare_mono_subdraw(lad, rung, sample.rate)
        if sub is None:
            return None
        self.staged.note_hit()
        _trace.annotate(staged=True, staged_table=table,
                        staged_rate=sample.rate, staged_rung=rung.rate)
        if sub.n_real == 0:
            # a fresh draw under the pinned seed would be empty too
            raise EmptySampleError(table, "block", sample.rate)
        runtimes, infos = self._scan_runtimes(plan, exclude=table)
        self._check_empty(infos)
        runtimes[table] = ScanRuntime("block", sub.n_real, sub.n_phys,
                                      sub.phys, ids_dev=sub.phys_dev,
                                      nreal_dev=sub.nreal_dev)
        infos[table] = SampleInfo(
            "block", sample.rate, lad.seed, sub.n_real, lad.num_blocks,
            sub.sub_ids,
            scanned_bytes=scan_cost_bytes(origin, "block", sub.n_real))
        return self._execute_drawn(plan, runtimes, infos, t0, sub.compiler)

    def _execute_drawn(self, plan: L.Aggregate, runtimes, infos, t0: float,
                       compiler: PhysicalCompiler) -> QueryResult:
        """The device half of :meth:`execute`, on a sample already drawn
        (through ``compiler``, a staged rung's, or the executor's own)."""
        compiled = compiler.compile_query(plan, runtimes)
        # Predicate/expression constants ride as a runtime operand: the
        # compiled callable is shared across every constant variant.
        self._count("device_dispatches")
        sums_d, counts_d = compiled(runtimes, plan_constants(plan))
        # the single device→host boundary of the query
        sums = sums_d.double().cpu().numpy()
        counts = counts_d.double().cpu().numpy()
        values = self._compose_values(plan, sums, counts, self._upscale(infos))
        return QueryResult(
            agg_names=[a.name for a in plan.aggs],
            values=values,
            raw_sums=sums,
            group_counts=counts,
            group_present=counts > 0,
            scanned_bytes=compiled.scanned_bytes(runtimes),
            sample_infos=infos,
            wall_time_s=time.perf_counter() - t0,
        )

    # -- batched execution (drain-group finals) ------------------------------
    def _execute_captured(self, plan: L.Aggregate):
        """execute(), with EmptySampleError returned instead of raised (the
        per-member contract of :meth:`execute_batch`)."""
        try:
            return self.execute(plan)
        except EmptySampleError as e:
            return e

    def execute_batch(self, plans: List[L.Aggregate],
                      on_result: Optional[Callable] = None) -> List[object]:
        """Execute several plans, running members that share a compile key
        (:meth:`PhysicalCompiler.query_signature`: the constant-hoisted plan
        signature with sampling methods and bucketed id lengths) as ONE
        batched kernel launch per chunk.

        Returns one entry per plan, position-aligned: a
        :class:`QueryResult`, or the :class:`EmptySampleError` that member's
        sampled scan raised (callers take their per-member exact fallback,
        as on the serial path).  ``on_result(i, result)``, if given, runs
        as each entry lands: per member on the solo path, per chunk on the
        batched one.

        Buckets split greedily into power-of-two chunks (5 members run as
        4 + 1), so batch callables recur in log-many sizes with no padded
        lanes; a chunk of one runs solo on the sample already drawn.  Plans
        that sample no table run solo, and so do members the staged route
        serves (their dispatch is already the cheap one, and batching them
        would redraw fresh), and every member of the eager executor.  A
        failing batched call raises to the caller — it is never re-run as
        solo launches.
        """
        results: List[object] = [None] * len(plans)

        def land(i: int, res: object) -> None:
            results[i] = res
            if on_result is not None:
                on_result(i, res)

        if not self.use_compiled or len(plans) < 2:
            for i, p in enumerate(plans):
                land(i, self._execute_captured(p))
            return results

        drawn: Dict[int, tuple] = {}
        buckets: Dict[tuple, List[int]] = {}
        for i, plan in enumerate(plans):
            if self._staged_route(plan) is not None:
                land(i, self._execute_captured(plan))
                continue
            t0 = time.perf_counter()
            runtimes, infos = self._scan_runtimes(plan)
            try:
                self._check_empty(infos)
            except EmptySampleError as e:
                self._count("queries_run")
                land(i, e)
                continue
            if all(r.method == "none" for r in runtimes.values()):
                self._count("queries_run")
                land(i, self._execute_drawn(plan, runtimes, infos, t0,
                                            self.physical))
                continue
            drawn[i] = (runtimes, infos)
            key = self.physical.query_signature(plan, runtimes)
            buckets.setdefault(key, []).append(i)

        for idxs in buckets.values():
            while idxs:
                take = 1 << (len(idxs).bit_length() - 1)
                chunk, idxs = idxs[:take], idxs[take:]
                if len(chunk) == 1:
                    i = chunk[0]
                    self._count("queries_run")
                    land(i, self._execute_drawn(plans[i], *drawn[i],
                                                time.perf_counter(),
                                                self.physical))
                    continue
                self._run_bucket(plans, chunk, drawn, results)
                if on_result is not None:
                    for i in chunk:
                        on_result(i, results[i])
        return results

    def _run_bucket(self, plans, idxs, drawn, results) -> None:
        """One batched launch for members ``idxs`` of one bucket."""
        t0 = time.perf_counter()
        compiled = self.physical.compile_batched_query(
            plans[idxs[0]], drawn[idxs[0]][0], len(idxs))
        self._count("device_dispatches")
        sums_d, counts_d = compiled.call_batch(
            [drawn[i][0] for i in idxs],
            [plan_constants(plans[i]) for i in idxs])
        # one device→host boundary for the whole bucket
        sums_b = sums_d.double().cpu().numpy()
        counts_b = counts_d.double().cpu().numpy()
        wall = time.perf_counter() - t0
        for k, i in enumerate(idxs):
            self._count("queries_run")
            runtimes, infos = drawn[i]
            sums, counts = sums_b[k], counts_b[k]
            results[i] = QueryResult(
                agg_names=[a.name for a in plans[i].aggs],
                values=self._compose_values(plans[i], sums, counts,
                                            self._upscale(infos)),
                raw_sums=sums,
                group_counts=counts,
                group_present=counts > 0,
                scanned_bytes=compiled.scanned_bytes(runtimes),
                sample_infos=infos,
                wall_time_s=wall,
            )

    def execute_pilot(
        self,
        plan: L.Aggregate,
        pilot_table: str,
        theta_p: float,
        seed: int,
        pair_tables: Tuple[str, ...] = (),
    ) -> PilotStats:
        """Run the pilot query: block-sample ``pilot_table`` at theta_p and
        compute per-block sums of each simple aggregate plus ``__rows`` and,
        when ``pair_tables[0]`` sits alone on the right of a join, the
        per-(pilot block, right block) sums Lemma 4.8 needs.

        A table with a staged ladder draws from its pinned staging seed on
        every route, and a resident rung covering ``theta_p`` serves the
        draw as a memoized sub-draw of the staged realization, so hits,
        misses and undershoot retries replay one realization.

        Not counted here: ``pilots_run`` counts pilot *stages* and is
        incremented by :meth:`repro_torch.core.taqa.PilotDB.run_pilot`.
        """
        # One "scan" span per attempt: a stage's undershoot retries show as
        # sibling spans under the handle's "pilot" span.
        with _trace.span("scan", pilot=True, table=pilot_table,
                         theta_pilot=theta_p) as sp:
            if self.use_compiled:
                stats = self._execute_pilot_compiled(
                    plan, pilot_table, theta_p, seed, pair_tables)
            else:
                stats = self._execute_pilot_eager(
                    plan, pilot_table, theta_p,
                    self.staged.seed_for(pilot_table, seed), pair_tables)
            sp.set(scanned_bytes=stats.scanned_bytes,
                   n_blocks=stats.n_sampled_blocks)
        return stats

    def _execute_pilot_compiled(self, plan: L.Aggregate, pilot_table: str,
                                theta_p: float, seed: int,
                                pair_tables: Tuple[str, ...]) -> PilotStats:
        t0 = time.perf_counter()
        table = self.catalog[pilot_table]
        lad = self.staged.ladder(pilot_table)
        seed = seed if lad is None else lad.seed
        rung = (lad.rung_for(theta_p)
                if lad is not None and lad.sharded is None else None)
        # None also when the budget dropped the rung after rung_for
        sub = (prepare_mono_subdraw(lad, rung, theta_p)
               if rung is not None else None)
        if sub is not None:
            self.staged.note_hit()
            _trace.annotate(staged=True, staged_table=pilot_table,
                            staged_rate=theta_p, staged_rung=rung.rate)
            n_real = sub.n_real
        else:
            if lad is not None:
                self.staged.note_miss()
            ids = draw_block_ids(table.num_blocks, theta_p, seed)
            n_real = int(len(ids))
        names = [a.name for a in plan.aggs] + ["__rows"]

        if n_real == 0:
            other = {s.table for s in plan.scans() if s.table != pilot_table}
            scanned = sum(self.catalog[t].total_bytes() for t in other)
            return PilotStats(
                table=pilot_table, theta_p=theta_p, n_sampled_blocks=0,
                n_total_blocks=table.num_blocks, block_rows=table.block_rows,
                agg_names=names,
                block_sums=np.zeros((0, plan.max_groups, len(names))),
                group_present=np.zeros(plan.max_groups, bool),
                pair_sums={}, right_total_blocks={}, scanned_bytes=scanned,
                wall_time_s=time.perf_counter() - t0)

        if sub is not None:
            # positions within the rung, padded to the FRESH physical block
            # count: the same shapes, launch plans and masks, a smaller gather
            runtime = ScanRuntime("block", sub.n_real, sub.n_phys, sub.phys,
                                  ids_dev=sub.phys_dev, nreal_dev=sub.nreal_dev)
            compiler = sub.compiler
        else:
            phys, n_real, n_phys = pad_block_ids(ids, table.num_blocks)
            runtime = ScanRuntime("block", n_real, n_phys, phys)
            compiler = self.physical
        pair_table = pair_tables[0] if pair_tables else None
        compiled = compiler.compile_pilot(plan, pilot_table, runtime,
                                          pair_table)
        self._count("device_dispatches")
        bs_d, present_d, pair_d = compiled({pilot_table: runtime},
                                           plan_constants(plan))
        # the pilot's device→host boundary; the pair sums are sliced to the
        # real blocks on the device, then widened on the host
        block_sums = bs_d.double().cpu().numpy()[:n_real]
        present = present_d.cpu().numpy().astype(bool)
        pair_sums: Dict[str, np.ndarray] = {}
        right_total: Dict[str, int] = {}
        if pair_d is not None:
            pair_sums[pair_table] = pair_d[:n_real].cpu().double().numpy()
            right_total[pair_table] = self.catalog[pair_table].num_blocks
        return PilotStats(
            table=pilot_table,
            theta_p=theta_p,
            n_sampled_blocks=n_real,
            n_total_blocks=table.num_blocks,
            block_rows=table.block_rows,
            agg_names=names,
            block_sums=block_sums,
            group_present=present,
            pair_sums=pair_sums,
            right_total_blocks=right_total,
            scanned_bytes=compiled.scanned_bytes({pilot_table: runtime}),
            wall_time_s=time.perf_counter() - t0,
        )

    def _execute_pilot_eager(self, plan: L.Aggregate, pilot_table: str,
                             theta_p: float, seed: int,
                             pair_tables: Tuple[str, ...]) -> PilotStats:
        t0 = time.perf_counter()
        sampled_plan = L.rewrite_scans(
            plan, {pilot_table: L.SampleClause("block", theta_p, seed)})
        infos: Dict[str, SampleInfo] = {}
        pair_for = (pilot_table, pair_tables[0]) if pair_tables else None
        table = self._run_relational(sampled_plan.child, infos, pair_for)

        # one channel per simple aggregate plus the trailing row count
        # ("__rows"), which detects group presence
        exprs = [None if a.op == "count" else a.expr for a in plan.aggs] + [None]
        names = [a.name for a in plan.aggs] + ["__rows"]
        ids = infos[pilot_table].sampled_block_ids
        if ids is None or len(ids) == 0:
            ids = np.zeros(0, dtype=np.int64)
            block_sums = np.zeros((0, plan.max_groups, len(exprs)))
        else:
            block_sums = ops.block_group_sums(table, exprs, plan.group_by,
                                              plan.max_groups, ids)
        pair_sums: Dict[str, np.ndarray] = {}
        right_total: Dict[str, int] = {}
        for rt in pair_tables:
            col = f"__rblock_{rt}"
            if col in table.columns and len(ids) > 0:
                nrb = self.catalog[rt].num_blocks
                pair_sums[rt] = ops.block_pair_sums(table, exprs, ids, col, nrb)
                right_total[rt] = nrb
        present = (block_sums[..., -1].sum(axis=0) > 0) if len(ids) \
            else np.zeros(plan.max_groups, bool)
        return PilotStats(
            table=pilot_table,
            theta_p=theta_p,
            n_sampled_blocks=int(len(ids)),
            n_total_blocks=self.catalog[pilot_table].num_blocks,
            block_rows=self.catalog[pilot_table].block_rows,
            agg_names=names,
            block_sums=block_sums,
            group_present=present,
            pair_sums=pair_sums,
            right_total_blocks=right_total,
            scanned_bytes=sum(i.scanned_bytes for i in infos.values()),
            wall_time_s=time.perf_counter() - t0,
        )

    # -- stacked pilots (shared-pilot drain groups) --------------------------
    def execute_pilots_batched(
        self,
        plans: List[L.Aggregate],
        pilot_table: str,
        thetas: List[float],
        runtimes_list: List[Dict[str, ScanRuntime]],
    ) -> List[PilotStats]:
        """One stacked call for B same-signature pilot scans.

        The caller (:meth:`repro_torch.core.taqa.PilotDB.run_pilots_batched`)
        has resolved each member's draw on the host, undershoot retries
        included, so every lane arrives with its final block ids; ``thetas``
        are the rates those ids were drawn at.  The group's block sums and
        presence cross to the host in ONE copy, widened to f64 as the solo
        pilot widens them, and lane k is bitwise member k's solo
        :meth:`execute_pilot`.  Pair-table, staged and sharded pilots never
        reach here: the caller sends them solo.
        """
        batch = len(plans)
        compiled = self.physical.compile_batched_pilot(
            plans[0], pilot_table, runtimes_list[0][pilot_table], batch)
        t0 = time.perf_counter()
        with _trace.span("scan", pilot=True, table=pilot_table,
                         batched=batch) as sp:
            self._count("device_dispatches")
            bs_d, present_d = compiled.call_batch(
                runtimes_list, [plan_constants(p) for p in plans])
            # the group's one device->host copy: block sums and presence
            # side by side (f32 -> f64 is exact, so the bits are the solo
            # pilot's)
            width = bs_d[0].numel()
            host = torch.cat([bs_d.reshape(batch, width),
                              present_d.to(bs_d.dtype)], dim=1).double().cpu().numpy()
            bs_b = host[:, :width].reshape(bs_d.shape)
            present_b = host[:, width:] > 0
            sp.set(n_blocks=sum(r[pilot_table].n_real for r in runtimes_list))
        wall = time.perf_counter() - t0
        table = self.catalog[pilot_table]
        out: List[PilotStats] = []
        for k, plan in enumerate(plans):
            runtime = runtimes_list[k][pilot_table]
            out.append(PilotStats(
                table=pilot_table,
                theta_p=thetas[k],
                n_sampled_blocks=runtime.n_real,
                n_total_blocks=table.num_blocks,
                block_rows=table.block_rows,
                agg_names=[a.name for a in plan.aggs] + ["__rows"],
                block_sums=bs_b[k, :runtime.n_real],
                group_present=present_b[k],
                pair_sums={},
                right_total_blocks={},
                scanned_bytes=compiled.scanned_bytes(runtimes_list[k]),
                wall_time_s=wall,
            ))
        return out

    # -- fused single-launch TAQA --------------------------------------------
    def execute_fused(self, plan: L.Aggregate, pilot_table: str,
                      runtimes: Dict[str, ScanRuntime], solve: np.ndarray,
                      scal: np.ndarray, u: np.ndarray,
                      solve_channels: Tuple[int, ...]):
        """Run the single-launch TAQA program and return its outputs on the
        host, with the program that ran them.

        The caller (:meth:`repro_torch.core.taqa.PilotDB.run_fused`) owns
        every host-side decision: it drew the pilot, built the quantile
        table, the cost line and the final draw's uniforms, and it re-solves
        the rate in f64 afterwards and verifies the device's draw before
        trusting the returned sums.  One dispatch: the pilot, the solve, the
        draw and the final are queued on the card with one 8-byte read of
        (nsel, flags) before the final (``physical._build_fused``).
        ``padded`` comes back cut to its nsel real ids; ``sums`` and
        ``counts`` are None where nsel is 0.
        """
        compiled = self.physical.compile_fused(plan, pilot_table, runtimes,
                                               tuple(solve_channels))
        with _trace.span("scan", fused=True, table=pilot_table) as sp:
            self._count("device_dispatches")
            bs_d, present_d, theta_d, flags, nsel, padded_d, sums_d, counts_d = \
                compiled.call_fused(runtimes, plan_constants(plan), solve, scal, u)
            # the program's device→host boundary
            theta, theta_eff = theta_d.tolist()
            out = {
                "block_sums": bs_d.double().cpu().numpy(),
                "present": present_d.cpu().numpy().astype(bool),
                "theta": theta,
                "theta_eff": theta_eff,
                "flags": flags,
                "nsel": nsel,
                "padded": padded_d[:nsel].cpu().numpy(),
                "sums": None if sums_d is None else sums_d.double().cpu().numpy(),
                "counts": None if counts_d is None else counts_d.double().cpu().numpy(),
            }
            sp.set(n_blocks=runtimes[pilot_table].n_real,
                   theta_final=theta, fused_flags=int(flags))
        return out, compiled
