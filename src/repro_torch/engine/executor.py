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
join's pair table, per-block-pair sums), and runs a drain group's finals in
batches (``execute_batch``: members that share a compile key run as one
batched call).  A sampled scan that draws zero blocks or rows raises
:class:`EmptySampleError` instead of fabricating an upscale factor — callers
take their exact fallback.

Each query (each batch) crosses the device→host boundary once, where its
sums are widened to f64 for the host-side upscale and rate solve.
"""

from __future__ import annotations

import dataclasses
import threading
import time
from typing import Callable, Dict, List, Optional, Tuple

import numpy as np

from repro_torch.device import resolve_device
from repro_torch.engine import logical as L
from repro_torch.engine.physical import (PhysicalCompiler, ScanRuntime,
                                         plan_constants, scan_cost_bytes)
from repro_torch.engine.sampling import (SampleInfo, draw_block_ids,
                                         draw_row_sample, pad_block_ids)
from repro_torch.engine.table import BlockTable


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
    def __init__(self, catalog: Dict[str, BlockTable], *, device="cuda"):
        self.device = resolve_device(device)
        self.catalog: Dict[str, BlockTable] = {}
        for name, table in catalog.items():
            self.register_table(name, table)
        self.physical = PhysicalCompiler(self.catalog)
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

    # -- table metadata (the "DBMS statistics" TAQA consults) ---------------
    def table_rows(self, name: str) -> int:
        return self.catalog[name].num_rows

    def table_blocks(self, name: str) -> int:
        return self.catalog[name].num_blocks

    def block_rows(self, name: str) -> int:
        return self.catalog[name].block_rows

    def table_bytes(self, name: str) -> int:
        return self.catalog[name].total_bytes()

    def compile_cache_info(self):
        """Hit/miss/size counters of the physical-plan signature cache."""
        return self.physical.cache_info()

    # -- host-side sampling decisions ---------------------------------------
    def _scan_runtimes(
        self, plan: L.Plan,
    ) -> Tuple[Dict[str, ScanRuntime], Dict[str, SampleInfo]]:
        """Draw every scan's TABLESAMPLE decision (host RNG, as a DBMS picks
        pages before scanning) and package it as compiled-callable inputs —
        the reference's draw bit for bit."""
        runtimes: Dict[str, ScanRuntime] = {}
        infos: Dict[str, SampleInfo] = {}
        for s in plan.scans():
            table = self.catalog[s.table]
            if s.sample is None:
                runtimes[s.table] = ScanRuntime("none")
                infos[s.table] = SampleInfo(
                    "none", 1.0, 0, table.num_blocks, table.num_blocks,
                    np.arange(table.num_blocks),
                    scanned_bytes=scan_cost_bytes(table, "none"))
            elif s.sample.method == "block":
                ids = draw_block_ids(table.num_blocks, s.sample.rate,
                                     s.sample.seed)
                phys, n_real, n_phys = pad_block_ids(ids, table.num_blocks)
                runtimes[s.table] = ScanRuntime("block", n_real, n_phys, phys)
                infos[s.table] = SampleInfo(
                    "block", s.sample.rate, s.sample.seed, n_real,
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

    # -- public API ----------------------------------------------------------
    def execute(self, plan: L.Aggregate) -> QueryResult:
        self._count("queries_run")
        t0 = time.perf_counter()
        runtimes, infos = self._scan_runtimes(plan)
        self._check_empty(infos)
        return self._execute_drawn(plan, runtimes, infos, t0)

    def _execute_drawn(self, plan: L.Aggregate, runtimes, infos,
                       t0: float) -> QueryResult:
        """The device half of :meth:`execute`, on a sample already drawn."""
        compiled = self.physical.compile_query(plan, runtimes)
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
        that sample no table run solo.  A failing batched call raises to the
        caller — it is never re-run as solo launches.
        """
        results: List[object] = [None] * len(plans)

        def land(i: int, res: object) -> None:
            results[i] = res
            if on_result is not None:
                on_result(i, res)

        if len(plans) < 2:
            for i, p in enumerate(plans):
                land(i, self._execute_captured(p))
            return results

        drawn: Dict[int, tuple] = {}
        buckets: Dict[tuple, List[int]] = {}
        for i, plan in enumerate(plans):
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
                land(i, self._execute_drawn(plan, runtimes, infos, t0))
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
                                                time.perf_counter()))
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

        Not counted here: ``pilots_run`` counts pilot *stages* and is
        incremented by :meth:`repro_torch.core.taqa.PilotDB.run_pilot`.
        """
        t0 = time.perf_counter()
        table = self.catalog[pilot_table]
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

        phys, n_real, n_phys = pad_block_ids(ids, table.num_blocks)
        runtime = ScanRuntime("block", n_real, n_phys, phys)
        pair_table = pair_tables[0] if pair_tables else None
        compiled = self.physical.compile_pilot(plan, pilot_table, runtime,
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
