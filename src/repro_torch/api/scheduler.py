"""Query scheduler: signature-grouped, submission-fair draining.

Many users send streams of structurally identical queries — the same
dashboard refreshed by many clients, often with *shifted predicate
constants* (a sliding date range).  Constants are hoisted out of the
physical layer's compile keys (``engine/physical.plan_signature``) and ride
as runtime operands, so constant-varied queries share one callable; this
scheduler groups by the same constant-stripped *template* signature so those
queries also drain as one group and their finals can launch as one batched
kernel:

* submissions queue as :class:`QueryHandle`\\ s (seeds derive from query
  content at submission, so scheduling order never changes sampling),
* draining groups pending handles by their template signature
  (``core.taqa.template_signature``, computed once at submission and
  carried on the handle) and hands the groups to the session's
  :class:`repro_torch.runtime.AsyncRuntime` — groups run concurrently on the
  worker pool, one pilot is shared within each group's (full
  constant-bearing signature, pilot-params) subgroup, cached answers
  short-circuit execution, and same-bucket finals share one launch,
* groups are *admitted* in order of their earliest submission and members
  in submission order, so no query starves behind an unrelated hot group;
  ``max_queries`` caps one drain call.

``drain()`` blocks until its batch finished and returns handles in the fair
admission order; ``drain_async()`` dispatches everything pending and returns
immediately — callers observe completion via ``handle.poll()`` /
``handle.wait()``.
"""

from __future__ import annotations

import dataclasses
import time
from typing import TYPE_CHECKING, Dict, List, Optional

from repro_torch.core.taqa import structural_signature, template_signature

if TYPE_CHECKING:  # circular at runtime: session owns the scheduler
    from repro_torch.api.session import QueryHandle, Session


@dataclasses.dataclass
class DrainStats:
    """What one ``drain()`` call did to the caches and the queue.

    ``pilots_run`` and ``result_hits`` are attributed per handle (from the
    batch's own reports and flags), so concurrent activity elsewhere on the
    session never leaks in.  ``compile_misses``/``compile_hits`` diff the
    session's compile cache around the drain — exact when nothing else
    executes concurrently.  Every field is PER DRAIN: a fresh ``DrainStats``
    replaces ``scheduler.last_drain`` on each call; cumulative totals live
    in ``scheduler.total_drained``, the session's cache infos and its
    metrics registry (``session.metrics``).
    """

    n_queries: int = 0
    n_groups: int = 0
    compile_misses: int = 0   # new physical compilations this drain
    compile_hits: int = 0     # warm executions this drain
    pilots_run: int = 0       # pilot stages executed for this batch
    result_hits: int = 0      # batch answers served from the result cache
    wall_time_s: float = 0.0
    group_sizes: List[int] = dataclasses.field(default_factory=list)
    # pilot-subgroup fan-outs this drain (groups with >= 2 pilot
    # subgroups): concurrent span vs the sum of the per-subgroup durations
    pilot_fanouts: int = 0
    pilot_fanout_wall_s: float = 0.0
    pilot_fanout_serial_s: float = 0.0
    # the runtime pool widths this drain ran on (resolved, not the config)
    workers: int = 0
    pilot_workers: int = 0
    # progressive streaming (repro_torch.stream), over this drain's
    # STREAMING handles: frames emitted, drain-relative time of the first
    # frame of any kind (the first advisory estimate a client could
    # render), and of the last terminal frame (every guarantee delivered).
    # All 0.0 when no handle in the batch streamed.
    frames_emitted: int = 0
    time_to_first_frame_s: float = 0.0
    time_to_final_s: float = 0.0

    @property
    def cache_hit_rate(self) -> float:
        total = self.compile_hits + self.compile_misses
        return self.compile_hits / total if total else 0.0


class QueryScheduler:
    def __init__(self, session: "Session"):
        self._session = session
        self._pending: List["QueryHandle"] = []
        self._queued: set = set()  # query ids, for idempotent resubmits
        # dispatched-but-unfinished handles: a retried submit() during an
        # async drain must not re-queue a handle a worker is executing
        self._in_flight: Dict[int, "QueryHandle"] = {}
        self.last_drain: Optional[DrainStats] = None
        self.total_drained = 0

    def _prune_in_flight(self) -> None:
        self._in_flight = {qid: h for qid, h in self._in_flight.items()
                           if not h.done}

    def submit(self, handle: "QueryHandle") -> "QueryHandle":
        if handle.done:
            return handle  # pre-failed: nothing to run
        self._prune_in_flight()
        if handle.query_id in self._queued \
                or handle.query_id in self._in_flight:
            return handle  # idempotent: never double-queue a handle
        if handle.signature is None:
            handle.signature = structural_signature(handle.query)
        if handle.group_key is None:
            handle.group_key = template_signature(handle.query)
        self._queued.add(handle.query_id)
        self._pending.append(handle)
        if handle._trace is not None:
            # opened here on the client thread, closed by whichever worker
            # starts the query (_mark_running): the wait in the queue
            handle._trace.open_span("schedule")
        return handle

    @property
    def pending_count(self) -> int:
        return len(self._pending)

    def _grouped(self) -> List[List["QueryHandle"]]:
        groups: Dict[object, List["QueryHandle"]] = {}
        for h in self._pending:
            # constant-stripped template: constant-varied herds drain as one
            # group; pilot sharing re-splits on the full signature inside it
            groups.setdefault(h.group_key or h.signature, []).append(h)
        # submission-fair: a group runs no earlier than its first member's
        # arrival; members keep submission order within the group
        return sorted(groups.values(), key=lambda g: g[0].query_id)

    def _take_batch(self, max_queries: Optional[int]) -> List[List["QueryHandle"]]:
        """Dequeue up to ``max_queries`` handles as signature-grouped batches
        in fair order; the remainder stays pending."""
        batches: List[List["QueryHandle"]] = []
        taken = 0
        for group in self._grouped():
            if max_queries is not None and taken >= max_queries:
                break
            batch = group if max_queries is None else \
                group[: max_queries - taken]
            batches.append(batch)
            taken += len(batch)
        dispatched = {h.query_id for b in batches for h in b}
        self._pending = [h for h in self._pending
                         if h.query_id not in dispatched]
        self._queued -= dispatched
        self._prune_in_flight()
        for b in batches:
            for h in b:
                self._in_flight[h.query_id] = h
        return batches

    def drain(self, max_queries: Optional[int] = None) -> List["QueryHandle"]:
        """Run pending queries grouped by plan signature; return completed
        handles in fair admission order.  ``max_queries`` bounds one batch —
        the remainder stays queued for the next call."""
        if max_queries is not None and max_queries < 1:
            raise ValueError(f"max_queries must be >= 1, got {max_queries}")
        t0 = time.perf_counter()
        info0 = self._session.compile_cache_info()
        fan0 = self._session.runtime.pilot_fanout_totals()
        batches = self._take_batch(max_queries)
        self._session.runtime.run_groups(batches, block=True)
        completed = [h for b in batches for h in b]

        stats = DrainStats()
        stats.workers = self._session.runtime.workers
        stats.pilot_workers = self._session.runtime.pilot_workers
        stats.n_groups = len(batches)
        stats.group_sizes = [len(b) for b in batches]
        info1 = self._session.compile_cache_info()
        stats.n_queries = len(completed)
        stats.compile_misses = info1.misses - info0.misses
        stats.compile_hits = info1.hits - info0.hits
        # per-handle attribution: a pilot stage belongs to this batch when a
        # non-cached member's report records its own (non-shared) pilot run
        stats.result_hits = sum(1 for h in completed if h.cached)
        stats.pilots_run = sum(
            1 for h in completed
            if not h.cached and h.report is not None
            and h.report.pilot_ran and not h.report.pilot_shared)
        fan1 = self._session.runtime.pilot_fanout_totals()
        stats.pilot_fanouts = fan1[0] - fan0[0]
        stats.pilot_fanout_wall_s = fan1[1] - fan0[1]
        stats.pilot_fanout_serial_s = fan1[2] - fan0[2]
        # streaming latency, drain-relative: emission stamps predating this
        # drain (frames replayed onto pre-enabled handles) clamp to 0
        emits: List[float] = []
        finals: List[float] = []
        for h in completed:
            if not h.streaming:
                continue
            for f in h.frames():
                emits.append(f.t_emit)
                if f.terminal:
                    finals.append(f.t_emit)
        stats.frames_emitted = len(emits)
        if emits:
            stats.time_to_first_frame_s = max(0.0, min(emits) - t0)
        if finals:
            stats.time_to_final_s = max(0.0, max(finals) - t0)
        stats.wall_time_s = time.perf_counter() - t0
        self.last_drain = stats
        self.total_drained += len(completed)
        metrics = self._session.metrics  # cumulative totals live there
        metrics.counter("pilotdb_drains_total",
                        "drain() calls completed").inc()
        metrics.counter("pilotdb_drained_queries_total",
                        "Queries completed via drain()").inc(len(completed))
        metrics.histogram("pilotdb_drain_wall_seconds",
                          "Wall time per drain() call").observe(
                              stats.wall_time_s)
        # observed only when the batch streamed (zeros would poison the
        # quantiles)
        if emits:
            metrics.histogram(
                "pilotdb_time_to_first_frame_seconds",
                "Drain-relative time of the first streamed frame"
            ).observe(stats.time_to_first_frame_s)
        if finals:
            metrics.histogram(
                "pilotdb_time_to_final_seconds",
                "Drain-relative time of the last terminal frame"
            ).observe(stats.time_to_final_s)
        ts = self._session.timeseries
        if ts is not None:
            ts.record_drain(
                stats.time_to_first_frame_s if emits else None,
                stats.time_to_final_s if finals else None)
        return completed

    def drain_async(self) -> List["QueryHandle"]:
        """Dispatch everything pending to the runtime and return the
        dispatched handles immediately (they finish in the background; with
        ``async_workers=0`` this degenerates to a blocking drain).  No
        :class:`DrainStats` are recorded."""
        batches = self._take_batch(None)
        handles = [h for b in batches for h in b]
        self._session.runtime.run_groups(batches, block=False)
        self.total_drained += len(handles)
        return handles
