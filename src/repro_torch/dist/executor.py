"""Shard-parallel plan execution over partitioned tables.

:class:`DistExecutor` extends the engine :class:`Executor` with partitioned
registrations (:meth:`register_sharded`): a table registered with N shards
keeps its monolithic tensors in the catalog (metadata, exact execution and
fallbacks are untouched) while block-sampled scans of it fan out as ONE
dispatch per shard holding sampled blocks, each against that shard's own
tensors (:mod:`repro_torch.dist.shard`), and re-join through
:mod:`repro_torch.dist.merge`.

Route.  Per-shard dispatches reuse the physical layer's *pilot* lowering —
the per-(sampled block, group) channel sums — because per-block statistics
are exactly the mergeable unit (§4: block sampling commutes with the plan
suffix).  On the card that is the column kernels for kernel-shaped plans and
the gather route's ``segment_sum`` slab route for the rest, over each shard's
local block ids.  Final answers reduce the merged per-block sums in f64 over
the global block order; pilot statistics ARE the merged matrix.  Both are
bit-identical for every shard count by construction (see merge.py).  Every
shard has its own compiler and signature cache, and the compilers share
their builds (:class:`repro_torch.engine.physical.SharedBuildStore`), so a
shard geometry builds once and every shard of it re-dispatches warm.

Scope (enforced by fallback): the dist route takes plans whose SINGLE
sharded table carries a block sample at rate < 1; unsharded tables in the
plan (join sides) are replicated to every shard's catalog view.  Everything
else — exact scans, row sampling, plans sampling several tables — runs on
the monolithic tensors, which are shard-count-independent by definition.
An empty GLOBAL draw raises :class:`EmptySampleError` exactly as the
monolithic samplers do; an empty single shard contributes nothing.

Accounting.  Each shard is charged its own sampled slabs
(``shard_scan_info()`` — cumulative per-shard scanned bytes, summing to the
monolithic total for the same draw); replicated tables are charged once per
query, matching the monolithic attribution.
"""

from __future__ import annotations

import threading
import time
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from repro_torch.dist import merge
from repro_torch.dist.shard import ShardedTable, shard_block_ids
from repro_torch.engine import logical as L
from repro_torch.engine import syncs
from repro_torch.engine.executor import (EmptySampleError, Executor,
                                         PilotStats, QueryResult)
from repro_torch.engine.physical import (ScanRuntime, SharedBuildStore,
                                         plan_constants, scan_cost_bytes)
from repro_torch.engine.sampling import SampleInfo, pad_block_ids
from repro_torch.engine.staged import (DEFAULT_STAGED_RATES,
                                       build_sharded_ladder,
                                       prepare_dist_subdraw)
from repro_torch.engine.table import BlockTable
from repro_torch.obs import trace as _trace


class DistExecutor(Executor):
    """An :class:`Executor` whose catalog may hold partitioned tables."""

    def __init__(self, catalog: Dict[str, BlockTable], *, device="cuda",
                 staged_bytes: Optional[int] = None):
        # the shard state exists before the base class registers the catalog
        # through register_table
        self._sharded: Dict[str, ShardedTable] = {}
        # builds shared between the shard compilers: same-geometry shards
        # (equal block ranges shard into equal slab shapes) adopt each
        # other's builds, so N shards build each plan shape once; adoptions
        # show as ``shared_hits`` in compile_cache_info()
        self._shared_builds = SharedBuildStore()
        # one engine Executor per shard: its catalog holds the shard slice
        # under the table's name plus every other table's monolithic tensors
        self._shard_executors: Dict[str, List[Executor]] = {}
        self._shard_lock = threading.Lock()
        # cumulative per-shard sampled-slab bytes, per sharded table
        self._shard_scanned: Dict[str, List[int]] = {}
        super().__init__(catalog, device=device, staged_bytes=staged_bytes)

    # -- catalog management ---------------------------------------------------
    def register_sharded(self, name: str, table: BlockTable, shards: int,
                         devices=None) -> ShardedTable:
        """Register ``table`` partitioned into ``shards`` block ranges,
        round-robin over ``devices`` (default: every visible card for a
        table on one, the table's device for a CPU table:
        :func:`repro_torch.dist.shard.default_devices`).  A shard on another
        card gets its own executor there, with every other table of the
        catalog copied to that card.

        The monolithic tensors stay in the catalog (metadata / exact /
        fallback paths); block-sampled scans of ``name`` route per shard.
        Re-registering via :meth:`register_table` drops the partitioning.
        """
        sharded = ShardedTable.from_table(table, shards, devices=devices)
        super().register_table(name, table)
        # one copy of the other tables a card, whatever its count of shards
        replicas: Dict[torch.device, Dict[str, BlockTable]] = {}
        executors = []
        for s in sharded.shards:
            dev = s.table.device
            if dev not in replicas:
                replicas[dev] = {t: v.to(dev) for t, v in self.catalog.items()
                                 if t != name}
            cat = dict(replicas[dev])
            cat[name] = s.table
            executors.append(Executor(cat, device=dev,
                                      shared_builds=self._shared_builds))
        with self._shard_lock:
            self._sharded[name] = sharded
            self._shard_executors[name] = executors
            self._shard_scanned[name] = [0] * shards
        self._refresh_shard_catalogs(name, table)
        return sharded

    def register_staged(self, name: str, rates=DEFAULT_STAGED_RATES, *,
                        seed: int = 0) -> None:
        """Materialize a staged ladder; a sharded table stages PER SHARD —
        each shard gathers its restriction of the rung's one global draw, so
        the staged realization is shard-count-independent exactly like a
        fresh ``shard_block_ids`` draw."""
        snap = self._shard_snapshot(name)
        if snap is None:
            return super().register_staged(name, rates, seed=seed)
        sharded, executors = snap
        self.staged.admit(build_sharded_ladder(
            name, sharded, rates, seed, [ex.catalog for ex in executors]))

    def register_table(self, name: str, table: BlockTable) -> None:
        """Plain (monolithic) registration; drops any existing sharding of
        ``name`` and refreshes every shard view of it."""
        super().register_table(name, table)
        with self._shard_lock:
            self._sharded.pop(name, None)
            self._shard_executors.pop(name, None)
            self._shard_scanned.pop(name, None)
        self._refresh_shard_catalogs(name, table)

    def _refresh_shard_catalogs(self, name: str, table: BlockTable) -> None:
        """Other sharded tables' shard executors see ``name`` replicated —
        keep those views current when it is (re-)registered."""
        with self._shard_lock:
            items = [exs for t, exs in self._shard_executors.items() if t != name]
        copies = {}
        for executors in items:
            for ex in executors:
                dev = torch.device(ex.device)
                if dev not in copies:
                    copies[dev] = table.to(dev)
                ex.register_table(name, copies[dev])

    def sharded_tables(self) -> Dict[str, int]:
        with self._shard_lock:
            return {t: st.num_shards for t, st in self._sharded.items()}

    def is_sharded(self, name: str) -> bool:
        """Whether ``name`` currently executes as sharded sub-scans."""
        with self._shard_lock:
            return name in self._sharded

    def compile_cache_info(self):
        """Aggregate signature-cache counters: the monolithic compiler PLUS
        every shard executor's compiler — dist dispatches compile there, and
        session and drain stats must see them — with the shard compilers'
        adoptions of each other's builds as ``shared_hits``."""
        info = super().compile_cache_info()
        with self._shard_lock:
            executors = [ex for exs in self._shard_executors.values()
                         for ex in exs]
        for ex in executors:
            shard_info = ex.compile_cache_info()
            info.hits += shard_info.hits
            info.misses += shard_info.misses
            info.size += shard_info.size
            info.staged_hits += shard_info.staged_hits
            info.staged_misses += shard_info.staged_misses
            info.pilot_hits += shard_info.pilot_hits
            info.pilot_misses += shard_info.pilot_misses
            info.batched_hits += shard_info.batched_hits
            info.batched_misses += shard_info.batched_misses
            info.fused_hits += shard_info.fused_hits
            info.fused_misses += shard_info.fused_misses
            info.shared_hits += shard_info.shared_hits
        return info

    def shard_scan_info(self) -> Dict[str, Tuple[int, ...]]:
        """Cumulative sampled-slab bytes per shard, per sharded table.
        For any given draw the entries sum to the monolithic scanned-bytes
        attribution of the same sampled block set."""
        with self._shard_lock:
            return {t: tuple(v) for t, v in self._shard_scanned.items()}

    def _note_shard_scan(self, table: str, shard_index: int, nbytes: int) -> None:
        with self._shard_lock:
            if table in self._shard_scanned:
                self._shard_scanned[table][shard_index] += nbytes

    # -- routing --------------------------------------------------------------
    def _dist_route(self, plan: L.Aggregate) -> Optional[Tuple[str, L.SampleClause]]:
        """The (table, block-sample) pair when ``plan`` takes the dist
        route; None -> monolithic execution (shard-count-independent)."""
        if not self._sharded:
            return None
        scans = plan.scans()
        hits = [s for s in scans
                if s.table in self._sharded and s.sample is not None
                and s.sample.method == "block" and s.sample.rate < 1.0]
        if len(hits) != 1:
            return None
        target = hits[0]
        for s in scans:
            if s is not target and s.sample is not None and s.sample.rate < 1.0:
                return None  # multi-table sampling: monolithic fallback
        return target.table, target.sample

    def _shard_snapshot(self, table: str):
        """One consistent (ShardedTable, executors) pair, taken under the
        lock: a concurrent re-registration must never pair one generation's
        shard ranges with another's executors, nor KeyError a query that
        routed before the sharding was dropped — such a query runs against
        the consistent OLD snapshot and the session's generation guard
        decides whether its answer is deliverable."""
        with self._shard_lock:
            sharded = self._sharded.get(table)
            if sharded is None:
                return None
            return sharded, self._shard_executors[table]

    # -- execution ------------------------------------------------------------
    def execute(self, plan: L.Aggregate) -> QueryResult:
        route = self._dist_route(plan)
        snap = self._shard_snapshot(route[0]) if route is not None else None
        if snap is None:  # unsharded plan, or sharding dropped concurrently
            return super().execute(plan)
        self._count("queries_run")
        return self._execute_dist(plan, route[0], route[1], *snap)

    def execute_batch(self, plans: List[L.Aggregate],
                      on_result=None) -> List[object]:
        """Dist-routed members run as per-shard dispatches (bit-identical to
        their solo execution by construction); the rest batch as usual.
        ``on_result`` keeps the base contract: dist members announce per
        member, the rest via the forwarded (index-remapped) callback."""
        dist_idx = {i for i, p in enumerate(plans)
                    if self._dist_route(p) is not None}
        if not dist_idx:
            return super().execute_batch(plans, on_result=on_result)
        results: List[object] = [None] * len(plans)
        rest = [i for i in range(len(plans)) if i not in dist_idx]
        if rest:
            remap = (None if on_result is None
                     else (lambda j, r: on_result(rest[j], r)))
            for i, r in zip(rest, super().execute_batch(
                    [plans[i] for i in rest], on_result=remap)):
                results[i] = r
        for i in sorted(dist_idx):
            results[i] = self._execute_captured(plans[i])
            if on_result is not None:
                on_result(i, results[i])
        return results

    def _replicated_infos(self, plan: L.Aggregate, table: str) -> Dict[str, SampleInfo]:
        infos: Dict[str, SampleInfo] = {}
        for s in plan.scans():
            if s.table == table or s.table in infos:
                continue
            tab = self.catalog[s.table]
            infos[s.table] = SampleInfo(
                "none", 1.0, 0, tab.num_blocks, tab.num_blocks,
                np.arange(tab.num_blocks),
                scanned_bytes=scan_cost_bytes(tab, "none"))
        return infos

    def _shard_plan(self, table: str, rate: float, seed: int,
                    sharded: ShardedTable, executors: List[Executor]):
        """The dist draw of ``table`` at ``rate``: ``(seed, global ids,
        staged, items)``: ``staged`` says whether staged rung parts serve
        it, and one item ``(shard index, start block, local ids, runtime,
        compiler)`` per shard holding sampled blocks, in shard order.

        A table with a ladder draws under its pinned seed.  When the ladder
        was staged over this very sharding and a resident rung covers
        ``rate``, each shard's blocks are addressed by POSITION within its
        staged rung part and read through the part's compiler, with the
        physical block count forced to the fresh per-shard value: the same
        rows, shapes and reduction order, so the merged answer is bitwise
        the fresh one.  Every route takes rungs, the column kernels too (the
        reference stages on its XLA route only).  ``sharded`` and
        ``executors`` come from one :meth:`_shard_snapshot`."""
        lad = self.staged.ladder(table)
        staged = None
        if lad is not None:
            seed = lad.seed
            rung = lad.rung_for(rate) if lad.sharded is sharded else None
            # None also when the budget dropped the rung after rung_for
            staged = (prepare_dist_subdraw(lad, rung, rate)
                      if rung is not None else None)
            if staged is None:
                self.staged.note_miss()
            else:
                self.staged.note_hit()
        if staged is not None:
            global_ids, splits = staged
            return seed, global_ids, True, [
                (sd.part.shard_index, sd.part.start_block, sd.local_ids,
                 ScanRuntime("block", sd.n_real, sd.n_phys, sd.phys,
                             ids_dev=sd.phys_dev, nreal_dev=sd.nreal_dev),
                 sd.part.compiler)
                for sd in splits]
        global_ids, parts_ids = shard_block_ids(sharded.num_blocks, rate,
                                                seed, sharded)
        items = []
        for s, local_ids in parts_ids:
            phys, n_real, n_phys = pad_block_ids(local_ids, s.num_blocks)
            items.append((s.index, s.start_block, local_ids,
                          ScanRuntime("block", n_real, n_phys, phys),
                          executors[s.index].physical))
        return seed, global_ids, False, items

    def _execute_dist(self, plan: L.Aggregate, table: str,
                      sample: L.SampleClause, sharded: ShardedTable,
                      executors: List[Executor]) -> QueryResult:
        t0 = time.perf_counter()
        with _trace.span("shard_fanout", table=table,
                         shards=sharded.num_shards) as sp:
            seed, global_ids, staged, items = self._shard_plan(
                table, sample.rate, sample.seed, sharded, executors)
            sp.set(staged=staged)
            if len(global_ids) == 0:
                raise EmptySampleError(table, "block", sample.rate)
            parts = self._dispatch(L.strip_samples(plan), table, sharded, items)
            sp.set(shards_hit=len(parts),
                   scanned_bytes=sum(p.scanned_bytes for p in parts))
        _, block_sums = merge.merge_block_stats(parts)
        sums, counts = merge.reduce_group_totals(block_sums)

        infos = self._replicated_infos(plan, table)
        infos[table] = SampleInfo(
            "block", sample.rate, seed, int(len(global_ids)),
            sharded.num_blocks, global_ids,
            scanned_bytes=sum(p.scanned_bytes for p in parts))
        values = self._compose_values(plan, sums, counts, self._upscale(infos))
        return QueryResult(
            agg_names=[a.name for a in plan.aggs],
            values=values,
            raw_sums=sums,
            group_counts=counts,
            # counts is the f64-summed "__rows" channel of the same merged
            # matrix: counts > 0 IS the presence bitmap (monolithic form)
            group_present=counts > 0,
            scanned_bytes=sum(i.scanned_bytes for i in infos.values()),
            sample_infos=infos,
            wall_time_s=time.perf_counter() - t0,
        )

    def _dispatch(self, stripped: L.Aggregate, table: str,
                  sharded: ShardedTable, items,
                  pair_table: Optional[str] = None) -> List[merge.ShardPart]:
        """One pilot-lowering dispatch per item of :meth:`_shard_plan`, in
        shard order on the current stream; the outputs cross to the host
        only after every shard was dispatched."""
        params = plan_constants(stripped)
        raw = []
        for index, start, local_ids, runtime, compiler in items:
            compiled = compiler.compile_pilot(stripped, table, runtime,
                                              pair_table)
            raw.append((index, start, local_ids, runtime.n_real,
                        compiled({table: runtime}, params)))
        parts = []
        for index, start, local_ids, n_real, (bs_d, _present, pair_d) in raw:
            nbytes = n_real * sharded.block_rows * sharded.row_bytes
            self._note_shard_scan(table, index, nbytes)
            bs_d = bs_d.double()
            with syncs.host_read(bs_d):
                block_sums = bs_d.cpu().numpy()[:n_real]
            pair_sums = None
            if pair_d is not None:
                pair_d = pair_d[:n_real]
                with syncs.host_read(pair_d):
                    pair_sums = pair_d.cpu().double().numpy()
            parts.append(merge.ShardPart(
                shard_index=index,
                global_ids=local_ids.astype(np.int64) + start,
                block_sums=block_sums, pair_sums=pair_sums,
                scanned_bytes=nbytes))
        return parts

    # -- pilot ----------------------------------------------------------------
    def execute_pilot(self, plan: L.Aggregate, pilot_table: str,
                      theta_p: float, seed: int,
                      pair_tables: Tuple[str, ...] = ()) -> PilotStats:
        snap = (self._shard_snapshot(pilot_table)
                if len(pair_tables) <= 1 else None)
        if snap is None:
            return super().execute_pilot(plan, pilot_table, theta_p, seed,
                                         pair_tables)
        sharded, executors = snap
        t0 = time.perf_counter()
        names = [a.name for a in plan.aggs] + ["__rows"]
        pair_table = pair_tables[0] if pair_tables else None
        replicated = sum(
            self.catalog[t].total_bytes()
            for t in {s.table for s in plan.scans()} if t != pilot_table)
        with _trace.span("shard_fanout", table=pilot_table, pilot=True,
                         shards=sharded.num_shards) as sp:
            _, global_ids, staged, items = self._shard_plan(
                pilot_table, theta_p, seed, sharded, executors)
            sp.set(staged=staged)
            parts = (self._dispatch(L.strip_samples(plan), pilot_table, sharded,
                                    items, pair_table)
                     if len(global_ids) else [])
            sp.set(shards_hit=len(parts),
                   scanned_bytes=sum(p.scanned_bytes for p in parts))
        has_pair = bool(parts) and parts[0].pair_sums is not None
        return merge.merge_pilot_stats(
            table=pilot_table,
            theta_p=theta_p,
            n_total_blocks=sharded.num_blocks,
            block_rows=sharded.block_rows,
            agg_names=names,
            max_groups=plan.max_groups,
            parts=parts,
            pair_table=pair_table if has_pair else None,
            n_right_blocks=(self.catalog[pair_table].num_blocks
                            if pair_table else 0),
            replicated_bytes=replicated,
            wall_time_s=time.perf_counter() - t0,
        )
