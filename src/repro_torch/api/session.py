"""Session — the stateful front door of the port.

A :class:`Session` owns the registered tables (plus optional per-column
string dictionaries), the :class:`Executor` whose signature cache makes
repeated structurally-identical queries run warm, a result cache of
finished answers, the scheduler and worker pool behind ``submit`` /
``drain``, and deterministic seed derivation.

Three front doors:

* ``session.sql(...)`` parses dialect SQL, runs TAQA's two stages (pilot on
  the device → f64 rate solve on the host → final on the device) and
  returns a finished :class:`QueryHandle` carrying status, the answer, the
  :class:`TaqaReport` and any fallback reason;
* ``session.table(...)`` starts a fluent :class:`QueryBuilder` that lowers
  to the same :class:`Query` as the SQL and runs (``run``) or queues
  (``submit``) it;
* ``session.submit(...)`` queues a handle and ``session.drain()`` runs the
  queue: grouped by template signature, one pilot per pilot-sharing
  subgroup, finals of one bucket in one batched kernel launch, answers
  bitwise those of ``sql`` on an equal-seed session.

Seed derivation is the reference's exactly: every query's sampling seed is
a pure function of ``(session seed, lowered query, ErrorSpec)`` and the
*pilot* seed of ``(session seed, structural signature, pilot-stage
tunables)``, both through ``blake2b(repr(parts))`` of the frozen plan and
spec dataclasses.  Equal-seed sessions of the two packages therefore draw
the same pilot and final blocks.

Grouped, joined, unioned and row-sampled queries run through the physical
layer's gather route.  ``register_table(..., staged_rates=, shards=)``
stages a table's sample ladder (:mod:`repro_torch.engine.staged`) and
partitions it into block-range shards (:mod:`repro_torch.dist`, whose
:class:`DistExecutor` is the session's default executor); answers are
bitwise the same for every ladder and every shard count.  The session runs
on the CUDA card by default and raises where there is none; ``device="cpu"``
runs the kernels' plain PyTorch versions.  ``SessionConfig(fused_taqa=True)``
runs an ungrouped query's two TAQA stages as one program on the device
(:meth:`repro_torch.core.taqa.PilotDB.run_fused`), bitwise the two-stage
answer.

Streaming and observability (all off by default, all read-only):
``sql(..., stream=True)`` / ``submit(..., stream=True)`` attach a frame
buffer, so :meth:`QueryHandle.stream` yields the advisory pilot estimate
(:class:`repro_torch.stream.PilotFrame`) as soon as stage 1 returns, then
exactly one terminal frame carrying the delivered answer object.
``SessionConfig(tracing=True)`` (or ``trace_sample=p``) records a span tree
per query (:meth:`QueryHandle.trace`, :meth:`QueryHandle.explain`);
``audit=True`` runs the exact query after delivery and records observed
against promised error; ``telemetry=True`` keeps per-template time-series
and SLO targets; ``flight_recorder=path`` logs every lifecycle event as a
JSONL line; ``Session.metrics`` holds the counters, histograms and
collector views over the caches and the runtime (:mod:`repro_torch.obs`).
With every hook off, a handle carries no trace, no frame buffer and no
completion hook; with any on, answers are bitwise the hooks-off answers:
the hooks never touch seeds, plans, cache keys or reductions, and add no
host read or device synchronization (every stage already ends in one).
"""

from __future__ import annotations

import bisect
import collections
import dataclasses
import hashlib
import os
import threading
import time
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from repro_torch.api.builder import QueryBuilder
from repro_torch.api.scheduler import QueryScheduler
from repro_torch.api.sql import (HavingClause, LimitClause, UnsupportedSqlError,
                                 parse_sql, resolve_string_literals)
from repro_torch.core.spec import ErrorSpec
from repro_torch.core.taqa import (ApproxAnswer, PilotDB, Query, TaqaReport,
                                   advisory_estimate, pilot_params,
                                   structural_signature)
from repro_torch.device import resolve_device
from repro_torch.dist import DistExecutor
from repro_torch.engine.executor import Executor
from repro_torch.engine.physical import plan_template
from repro_torch.engine.staged import DEFAULT_STAGED_RATES, validate_rates
from repro_torch.engine.table import BlockTable
from repro_torch.obs import audit as _audit
from repro_torch.obs import events as _events
from repro_torch.obs import metrics as _metrics
from repro_torch.obs import slo as _slo
from repro_torch.obs import timeseries as _timeseries
from repro_torch.obs import trace as _trace
from repro_torch.runtime import shared_pilot as _shared_pilot
from repro_torch.runtime.pool import AsyncRuntime
from repro_torch.runtime.result_cache import (CachedAnswer, ResultCache,
                                              ResultCacheInfo)
from repro_torch.stream import (ErrorFrame, FrameBuffer, final_frame_for,
                                pilot_frame_for)


class QueryStatus:
    PENDING = "pending"
    RUNNING = "running"
    DONE = "done"
    FAILED = "failed"


class QueryFailedError(RuntimeError):
    """Raised by :meth:`QueryHandle.result` when execution failed."""


@dataclasses.dataclass
class _Dictionary:
    """A column's string dictionary: code lookup plus order metadata."""

    codes: Dict[str, int]       # value -> integer code
    values: List[str]           # code -> value (registration order)
    is_sorted: bool             # strictly ascending => code order == lex order


def _content_hash(*parts) -> int:
    """Deterministic 64-bit hash of frozen-dataclass content (their reprs
    are complete and stable — plans, exprs and specs hold only scalars)."""
    digest = hashlib.blake2b(repr(parts).encode(), digest_size=8).digest()
    return int.from_bytes(digest, "big")


@dataclasses.dataclass
class QueryHandle:
    """One submitted query: its lowered form, derived seed, and outcome."""

    query_id: int
    query: Optional[Query]
    spec: Optional[ErrorSpec]         # None -> exact execution was requested
    seed: int
    sql: Optional[str] = None
    # post-aggregation HAVING / [ORDER BY] LIMIT: applied to the delivered
    # answer, never part of the plan or the seed
    having: Optional[HavingClause] = None
    limit: Optional[LimitClause] = None
    status: str = QueryStatus.PENDING
    error: Optional[str] = None
    cached: bool = False              # answered from the session result cache
    _answer: Optional[ApproxAnswer] = None
    # full constant-bearing structural signature, computed once at
    # submission (pilot-seed derivation and pilot-sharing subgroups key off
    # it — pilot statistics depend on predicate constants)
    signature: Optional[object] = dataclasses.field(
        default=None, repr=False, compare=False)
    # constant-stripped template signature: the scheduler's grouping key —
    # constant-varied queries share compilations and batched final launches
    group_key: Optional[object] = dataclasses.field(
        default=None, repr=False, compare=False)
    _done_event: threading.Event = dataclasses.field(
        default_factory=threading.Event, repr=False, compare=False)
    # progressive streaming (repro_torch.stream): None until
    # enable_streaming(); the lock serializes terminal-frame emission
    # against late enabling so every stream ends in EXACTLY one terminal
    # frame
    _frames: Optional[FrameBuffer] = dataclasses.field(
        default=None, repr=False, compare=False)
    _frame_lock: threading.Lock = dataclasses.field(
        default_factory=threading.Lock, repr=False, compare=False)
    # submission instant (perf_counter): the zero point for every frame's
    # relative `emitted_at` stamp and for the trace's span times
    t_submit: float = dataclasses.field(
        default_factory=time.perf_counter, repr=False, compare=False)
    # query-lifecycle span tree (repro_torch.obs.trace); None unless the
    # session traces this query (tracing=True, or picked by trace_sample)
    _trace: Optional[_trace.QueryTrace] = dataclasses.field(
        default=None, repr=False, compare=False)
    # observed-vs-promised outcome (repro_torch.obs.audit); None unless the
    # session runs in audit mode and this query completed
    audit_record: Optional[_audit.AuditRecord] = dataclasses.field(
        default=None, repr=False, compare=False)
    # the fused single-launch program delivered this answer (set by
    # Session._run_fused; provenance and telemetry read it)
    _fused: bool = dataclasses.field(default=False, repr=False, compare=False)
    # picked by deterministic trace sampling (SessionConfig.trace_sample);
    # sampled traces land in the flight recorder and session.recent_traces
    _trace_sampled: bool = dataclasses.field(
        default=False, repr=False, compare=False)
    # the continuous-telemetry delivery hook (Session._observe_delivery),
    # fired exactly once after the done event; None (the default) keeps
    # completion as it is without telemetry
    _on_complete: Optional[object] = dataclasses.field(
        default=None, repr=False, compare=False)
    # 12-hex hash of the constant-stripped template signature: the
    # time-series / SLO / flight-recorder key (set only when telemetry is
    # armed)
    _template_key: Optional[str] = dataclasses.field(
        default=None, repr=False, compare=False)

    @property
    def done(self) -> bool:
        return self.status in (QueryStatus.DONE, QueryStatus.FAILED)

    @property
    def answer(self) -> Optional[ApproxAnswer]:
        return self._answer

    @property
    def report(self) -> Optional[TaqaReport]:
        return self._answer.report if self._answer is not None else None

    @property
    def fallback(self) -> Optional[str]:
        """Reason exact execution was used, if TAQA fell back (else None)."""
        r = self.report
        return r.fallback if r is not None else None

    # -- async observation ----------------------------------------------------
    def poll(self) -> str:
        """Non-blocking status probe: pending / running / done / failed."""
        return self.status

    def wait(self, timeout: Optional[float] = None) -> bool:
        """Block until the query finished (done OR failed); False on
        timeout.  Returns at once for handles finished synchronously."""
        if self.done:
            return True
        return self._done_event.wait(timeout)

    # -- progressive streaming (repro_torch.stream) ---------------------------
    @property
    def streaming(self) -> bool:
        return self._frames is not None

    def enable_streaming(self) -> "QueryHandle":
        """Attach a frame buffer to this handle (idempotent).

        Queries submitted with ``stream=True`` arrive enabled; enabling
        later still works — frames emitted before the buffer existed are
        not observed (they are advisory), and enabling on a finished handle
        synthesizes its terminal frame, so late subscribers always observe
        a complete stream.
        """
        with self._frame_lock:
            if self._frames is None:
                self._frames = FrameBuffer(self.query_id, t0=self.t_submit)
                if self.status == QueryStatus.DONE:
                    self._frames.push(final_frame_for(
                        self.query_id, self._answer, cached=self.cached))
                elif self.status == QueryStatus.FAILED:
                    self._frames.push(ErrorFrame(
                        query_id=self.query_id,
                        error=self.error or "query failed"))
        return self

    def stream(self, timeout: Optional[float] = None):
        """Blocking frame iterator: the advisory
        :class:`repro_torch.stream.PilotFrame` when the pilot produced one,
        then exactly one terminal frame — a :class:`FinalFrame` carrying the
        SAME answer object ``result()`` returns, an :class:`ExactFrame` on
        fallback, or an :class:`ErrorFrame` on a captured failure.
        Implicitly enables streaming; ``timeout`` bounds each wait for the
        next frame."""
        return self.enable_streaming()._frames.stream(timeout)

    def on_frame(self, cb) -> "QueryHandle":
        """Register ``cb(frame)`` for every frame of this query; frames
        already emitted are replayed first, in order.  Implicitly enables
        streaming."""
        self.enable_streaming()._frames.add_callback(cb)
        return self

    def frames(self) -> list:
        """Snapshot of the frames emitted so far ([] when not streaming)."""
        return [] if self._frames is None else self._frames.frames()

    def _emit(self, frame) -> None:
        """Push an advisory frame if this handle streams (no-op otherwise);
        terminal frames go through _mark_done/_mark_failed instead."""
        if self._frames is not None:
            self._frames.push(frame)

    # -- observability (repro_torch.obs) --------------------------------------
    def trace(self, fmt: str = "json"):
        """The query's span tree: a JSON-able dict (``fmt="json"``) or a
        Chrome trace-event list (``fmt="chrome"``).  None when the query
        was not traced."""
        if self._trace is None:
            return None
        if fmt == "chrome":
            return self._trace.to_chrome()
        if fmt == "json":
            return self._trace.to_dict()
        raise ValueError(f"unknown trace format {fmt!r} "
                         "(expected 'json' or 'chrome')")

    def explain(self) -> str:
        """EXPLAIN-style report: promised guarantee, solved rates, pilot
        inputs, scanned bytes, provenance (see :mod:`repro_torch.obs.audit`)."""
        return _audit.explain(self)

    # -- completion (runtime-internal) ----------------------------------------
    def _mark_running(self) -> None:
        if not self.done:
            self.status = QueryStatus.RUNNING
            if self._trace is not None:
                # the wait-in-queue span submit() opened on another thread
                self._trace.close_span("schedule")

    def _mark_done(self, answer: ApproxAnswer, cached: bool = False) -> None:
        with self._frame_lock:
            self._answer = answer
            self.cached = cached
            self.status = QueryStatus.DONE
            if self._frames is not None:
                self._frames.push(final_frame_for(
                    self.query_id, answer, cached=cached))
        if self._trace is not None:
            self._trace.finish("ok")
        self._done_event.set()
        self._fire_on_complete()

    def _fire_on_complete(self) -> None:
        """Run the telemetry delivery hook exactly once; it observes only
        and must never raise into the completion path."""
        cb, self._on_complete = self._on_complete, None
        if cb is not None:
            try:
                cb(self)
            except Exception:
                pass

    def _mark_failed(self, error: str) -> None:
        with self._frame_lock:
            self.status = QueryStatus.FAILED
            self.error = error
            if self._frames is not None:
                # failures become a terminal frame, never an exception
                # raised through a streaming client
                self._frames.push(ErrorFrame(query_id=self.query_id,
                                             error=error))
        if self._trace is not None:
            self._trace.finish("error", error=error)
        self._done_event.set()
        self._fire_on_complete()

    def result(self) -> ApproxAnswer:
        """The answer; raises if the query failed or has not run yet."""
        if self.status == QueryStatus.FAILED:
            raise QueryFailedError(self.error or "query failed")
        if self._answer is None:
            raise RuntimeError(
                f"query {self.query_id} is {self.status}; drain the session "
                "it was submitted to (session.drain()), or wait() on the "
                "handle after drain_async(), before reading results")
        return self._answer

    def scalar(self, name: str, group: int = 0) -> float:
        return self.result().scalar(name, group)


@dataclasses.dataclass(frozen=True)
class SessionConfig:
    large_table_rows: int = 50_000     # sampling threshold (§3.1)
    default_error: float = 0.05        # builder .error() defaults
    default_confidence: float = 0.95
    spec_kwargs: Optional[Dict] = None  # TAQA tunable overrides for SQL specs
    # The physical layer sizes dense per-(block, group) buffers by
    # max_groups; an id-cardinality GROUP BY would otherwise allocate
    # process-killing buffers in a shared server.
    max_groups_limit: int = 4096
    # -- concurrent runtime (repro_torch.runtime) ----------------------------
    # Worker threads draining signature groups concurrently; 0 runs groups
    # inline on the draining thread.  None sizes the pool from the core
    # count (see resolve_workers).  Answers never depend on it.
    async_workers: Optional[int] = None
    # One pilot per (full signature, pilot-params) subgroup, statistics
    # fanned out to every member (off: each query runs its own, bitwise
    # equal, pilot and its own final).  Never shared across predicate
    # constants.
    share_pilots: bool = True
    # Run a drain group's same-bucket finals as ONE batched kernel launch
    # (bitwise the solo launches).  Rides the shared-pilot group path, so
    # share_pilots=False also disables it.
    batch_finals: bool = True
    # Worker threads fanning a drain group's pilot SUBGROUPS out; separate
    # from the group pool, so group workers waiting on them cannot deadlock
    # it.  0 (the port's default, where the reference auto-sizes) runs them
    # one after another on the group's worker: the rate solves and host
    # draws hold the GIL, and threads fanning them out made the H100 host's
    # drain slower, not faster.  None auto-sizes as the reference does
    # (resolve_pilot_workers).
    pilot_workers: Optional[int] = 0
    # Session result-cache capacity in answers; 0 disables caching.
    result_cache_size: int = 128
    # Optional byte budget for the result cache: entries are stored compact
    # (values + error report + packed group-present bitmap + the advisory
    # pilot summary) and evicted LRU-first once the budget is hit.  None =
    # entry-count bound only.
    result_cache_bytes: Optional[int] = None
    # Optional byte budget for the staged sample catalog (tables registered
    # with staged_rates=...): rung tensors of cold ladders are evicted
    # LRU-first past the budget; the ladder's pinned staging seed survives
    # eviction, so answers stay bitwise equal across the hit/miss boundary.
    # None = unbounded residency.
    staged_bytes: Optional[int] = None
    # Run an ungrouped query's two TAQA stages as ONE program on the device
    # (pilot scan -> f32 rate solve -> final draw -> final scan, one 8-byte
    # host read before the final; engine/physical.py compile_fused).
    # Answers stay bitwise the two-stage path's: the program replays the
    # same content-derived draws through the same solo pilot and final
    # bodies, and delivery verifies the device's final draw against the
    # host draw before trusting the fused sums.  Grouped, join-pair and
    # sharded shapes take the two-stage path.  Off (default): two stages.
    fused_taqa: bool = False
    # -- observability (repro_torch.obs); every knob only observes ----------
    # Per-query span trees (handle.trace()).  Off: no trace objects exist.
    tracing: bool = False
    # After each approximate answer is DELIVERED, run the exact query on the
    # device and record observed vs promised error into the metrics
    # registry (never touches seeds, cache keys or delivered answers; adds
    # an exact scan per query).
    audit: bool = False
    # Per-template time-series + SLO evaluation on every delivery (bounded
    # rings keyed by the constant-stripped template signature: latency,
    # pilot wall, scanned bytes, provenance, audit error ratio).
    telemetry: bool = False
    # Ring capacity per template series and per drain-latency ring.
    timeseries_window: int = 256
    # Initial SLO targets (tuple of repro_torch.obs.slo.SloTarget); more via
    # session.slo.set_target(...).  Requires telemetry=True.
    slo_targets: Optional[Tuple] = None
    # Flight recorder: path of an append-only JSONL event log (submit /
    # pilot / rate_solve / final / deliver / fallback / fail / audit /
    # slo_breach / trace).  It never raises into the query path.  None
    # records nothing.
    flight_recorder: Optional[str] = None
    flight_recorder_max_bytes: int = 1 << 20   # rotate past this size
    flight_recorder_max_files: int = 3         # live file + rotated .1/.2
    # Attach a span tree to this fraction of queries, chosen by a hash of
    # (session seed, structural signature): equal-seed sessions sample the
    # same queries.  0.0 samples nothing; tracing=True traces everything.
    trace_sample: float = 0.0

    def resolve_workers(self) -> int:
        """The worker count ``async_workers=None`` sizes to: serial on <= 2
        cores (the GIL-bound rate solves gain nothing from a pool there),
        else one fewer than the cores, capped at 8."""
        if self.async_workers is not None:
            return self.async_workers
        cpus = os.cpu_count() or 1
        if cpus <= 2:
            return 0
        return min(8, cpus - 1)  # leave a core for the draining thread

    def resolve_pilot_workers(self) -> int:
        """The pilot-stage fan-out width: ``pilot_workers`` when set, and
        for ``None`` the reference's auto-size (serial on one core, else
        min(4, cores))."""
        if self.pilot_workers is not None:
            return self.pilot_workers
        cpus = os.cpu_count() or 1
        return 0 if cpus <= 1 else min(4, cpus)


class Session:
    """A client session against a catalog of block tables on one device."""

    def __init__(self, catalog: Optional[Dict[str, BlockTable]] = None, *,
                 seed: int = 0, config: SessionConfig = SessionConfig(),
                 device="cuda", executor: Optional[Executor] = None):
        self.config = config
        if config.spec_kwargs:
            # fail at construction, not on every client's ERROR clause
            dataclasses.replace(ErrorSpec(error=config.default_error,
                                          confidence=config.default_confidence),
                                **config.spec_kwargs)
        if executor is not None:
            if catalog is not None:
                raise ValueError(
                    "pass either catalog or executor, not both: an explicit "
                    "executor brings its own catalog, and the catalog "
                    "argument would be silently ignored")
            self.executor = executor
            self.device = executor.device
        else:
            self.device = resolve_device(device)
            # DistExecutor behaves exactly like Executor until a table is
            # registered with shards= (see register_table)
            self.executor = DistExecutor(catalog or {}, device=self.device,
                                         staged_bytes=config.staged_bytes)
        self.db = PilotDB(self.executor,
                          large_table_rows=config.large_table_rows)
        self._entropy = int(seed)
        self._next_id = 0
        self._max_groups_cache: Dict[tuple, int] = {}
        self._dictionaries: Dict[str, _Dictionary] = {}
        # Bumped by register_table; snapshotted when a query starts running
        # so an answer computed against since-replaced data is never
        # delivered or cached.  The lock makes bump+swap atomic with respect
        # to snapshots.
        self._table_gen: Dict[str, int] = {}
        self._gen_lock = threading.Lock()
        self.result_cache = ResultCache(config.result_cache_size,
                                        max_bytes=config.result_cache_bytes)
        self.runtime = AsyncRuntime(self, workers=config.resolve_workers(),
                                    pilot_workers=config.resolve_pilot_workers())
        self.scheduler = QueryScheduler(self)
        # the metrics registry: first-class instruments plus collector views
        # over the caches and the runtime this session already tracks
        self.metrics = _metrics.MetricsRegistry()
        # -- continuous telemetry (repro_torch.obs.timeseries / slo / events)
        if not 0.0 <= config.trace_sample <= 1.0:
            raise ValueError(
                f"trace_sample must be in [0, 1], got {config.trace_sample}")
        self.recorder = (_events.FlightRecorder(
            config.flight_recorder,
            max_bytes=config.flight_recorder_max_bytes,
            max_files=config.flight_recorder_max_files)
            if config.flight_recorder else None)
        self.timeseries = (_timeseries.TemplateTimeSeries(
            window=config.timeseries_window)
            if config.telemetry else None)
        self.slo = (_slo.SloMonitor(
            self.metrics, self.timeseries, recorder=self.recorder,
            targets=tuple(config.slo_targets or ()))
            if config.telemetry else None)
        if config.slo_targets and not config.telemetry:
            raise ValueError(
                "slo_targets requires telemetry=True (targets evaluate "
                "against the per-template time-series)")
        # the last sampled span trees (dict form)
        self.recent_traces: "collections.deque" = collections.deque(maxlen=16)
        # whether handles get the completion hook: any continuous-telemetry
        # surface is on (the default config arms nothing)
        self._telemetry_armed = (self.timeseries is not None
                                 or self.recorder is not None
                                 or config.trace_sample > 0.0)
        _metrics.register_session_collectors(self.metrics, self)
        self.auditor = (_audit.GuaranteeAuditor(self.db, self.metrics)
                        if config.audit else None)

    def close(self) -> None:
        """Shut the runtime's worker pools down and close the flight
        recorder (idempotent)."""
        self.runtime.shutdown()
        if self.recorder is not None:
            self.recorder.close()

    # -- catalog -------------------------------------------------------------
    def register_table(self, name: str, table: BlockTable, *,
                       dictionaries: Optional[Dict[str, Sequence[str]]] = None,
                       shards: Optional[int] = None,
                       staged_rates: Optional[Sequence[float]] = None,
                       ) -> None:
        """Add (or replace) a catalog table on this session's device.

        ``staged_rates=[...]`` also materializes a staged block-sample
        ladder for the table (``True`` takes the default 1% / 4% / 16%; per
        shard for a sharded registration): a sampled scan whose rate a rung
        covers runs on the rung's tensors as a sub-draw of the table's ONE
        content-derived staging realization — bitwise a fresh draw, for
        pilots and finals — without the per-query draw over every block.
        ``None`` (default) stages nothing.  Re-registration drops the old
        ladder first, so staged tensors never outlive their data.

        ``shards=N`` registers the table partitioned into N disjoint block
        ranges, placed round-robin over every visible card (shard i on
        ``cuda:{i % k}``, as the reference places them over
        ``jax.devices()``; a CPU table's stay on the CPU): block-sampled
        scans then run one dispatch per shard, each on its shard's card,
        merged through per-block statistics (:mod:`repro_torch.dist`), and
        answers are bitwise equal for EVERY shard count and placement.
        ``None`` (default) registers it whole.  A sharded registration
        keeps the whole table where it was registered (exact, row-sample
        and multi-table paths run on it); shards on the table's own card
        are views of it, and a shard on another card is a copy, beside a
        copy of every other registered table there.

        Registering ``name`` evicts the cached MAXGROUPS statistics of its
        columns and every result-cache entry whose plan scanned it.  A query
        of ``name`` in flight when the replacement lands fails with a
        retryable error rather than delivering a possibly-torn answer (see
        :meth:`_complete_handle`); one queued but not yet started runs on
        the new data.  ``dictionaries`` maps dictionary-encoded column names
        to their value lists (code = list index), enabling string literals
        for those columns in WHERE clauses.
        """
        if shards is not None:
            if not hasattr(self.executor, "register_sharded"):
                raise ValueError(
                    "shards= needs a dist-capable executor (repro_torch.dist."
                    "DistExecutor, the session default); the explicit "
                    "executor passed to this session does not support "
                    "sharding")
            # validate BEFORE the generation bump: a rejected registration
            # must not fail in-flight queries over unchanged data
            if not 1 <= shards <= table.num_blocks:
                raise ValueError(
                    f"shards must be in [1, {table.num_blocks}] (blocks are "
                    f"the atomic placement unit), got {shards}")
        if staged_rates is not None:
            # validate BEFORE the generation bump, like shards= above
            staged_rates = DEFAULT_STAGED_RATES if staged_rates is True \
                else validate_rates(staged_rates)
        # bump+swap under the generation lock: no snapshot interleaves
        # between the new generation and the new data
        with self._gen_lock:
            self._table_gen[name] = self._table_gen.get(name, 0) + 1
            if shards is None:
                self.executor.register_table(name, table)
            else:
                self.executor.register_sharded(name, table, shards)
            if staged_rates is not None:
                # stage inside the lock: the ladder (and its seed pinning)
                # becomes visible with the table swap, so no query sees the
                # table staged-rates-on but unstaged
                self.executor.register_staged(
                    name, staged_rates, seed=self._staged_seed_for(name))
        self._max_groups_cache = {k: v for k, v in
                                  self._max_groups_cache.items()
                                  if k[0] != name}
        # eviction after the bump: an in-flight query's cache insert either
        # sees the bump in its put guard (skipped) or lands before this
        # eviction (removed)
        self.result_cache.invalidate_table(name)
        if dictionaries:
            for column, values in dictionaries.items():
                self.register_dictionary(column, values)

    def register_dictionary(self, column: str, values: Sequence[str]) -> None:
        """Declare ``column`` as dictionary-encoded: ``values[i]`` is the
        string for integer code ``i``.  A lexicographically sorted
        dictionary also lowers order comparisons (``col < 'N'``)."""
        values = list(values)
        self._dictionaries[column] = _Dictionary(
            codes={v: i for i, v in enumerate(values)},
            values=values,
            is_sorted=all(a < b for a, b in zip(values, values[1:])))

    def tables(self) -> List[str]:
        return sorted(self.executor.catalog)

    def infer_max_groups(self, tables, column: str) -> int:
        """Group-id domain size for integer-coded group columns, from the
        catalog.  An unknown table or column resolves to 1 rather than
        raising: the inference is advisory."""
        if isinstance(tables, str):
            tables = (tables,)
        for name in tables:
            tab = self.executor.catalog.get(name)
            if tab is None or column not in tab.columns:
                continue
            key = (name, column)
            if key not in self._max_groups_cache:
                col = tab.columns[column][tab.valid].cpu().numpy()
                if col.size == 0:
                    self._max_groups_cache[key] = 1
                else:
                    # grouping requires non-negative integer group codes;
                    # a float/negative column would silently collapse groups
                    if not (np.issubdtype(col.dtype, np.integer)
                            or np.all(col == np.floor(col))):
                        raise UnsupportedSqlError(
                            f"GROUP BY {column}: column is not integer-coded "
                            f"(dtype {col.dtype}); group columns must hold "
                            "non-negative integer group ids")
                    if col.min() < 0:
                        raise UnsupportedSqlError(
                            f"GROUP BY {column}: negative group ids "
                            "(min {:g}) are not supported".format(col.min()))
                    self._max_groups_cache[key] = int(col.max()) + 1
            return self._max_groups_cache[key]
        return 1

    def compile_cache_info(self):
        return self.executor.compile_cache_info()

    def result_cache_info(self) -> ResultCacheInfo:
        return self.result_cache.info()

    # -- seed derivation ------------------------------------------------------
    def _derive_seed(self, query: Query, spec: Optional[ErrorSpec]) -> int:
        """Per-query seed as a pure function of session seed and query
        content (the reference's derivation, bit for bit)."""
        seq = np.random.SeedSequence(
            [self._entropy, _content_hash(query, spec)])
        return int(seq.generate_state(1, dtype=np.uint32)[0])

    def _pilot_seed_for(self, handle: QueryHandle) -> int:
        """Pilot seed from (session seed, structural signature, pilot-stage
        tunables) — NOT from the per-query seed (the reference's derivation,
        bit for bit)."""
        params = None if handle.spec is None else pilot_params(handle.spec)
        seq = np.random.SeedSequence(
            [self._entropy, 0x9E3779B9,
             _content_hash(handle.signature, params)])
        return int(seq.generate_state(1, dtype=np.uint32)[0])

    def _staged_seed_for(self, name: str) -> int:
        """The staging seed pinning table ``name``'s one staged realization:
        a function of (session seed, table name) only — not of the ladder's
        rates — so every ladder of a table stages the same realization (the
        reference's derivation, bit for bit)."""
        seq = np.random.SeedSequence(
            [self._entropy, 0x5A3D1ED, _content_hash(name)])
        return int(seq.generate_state(1, dtype=np.uint32)[0])

    # -- continuous telemetry (repro_torch.obs.timeseries / slo / events) ------
    def _trace_sampled(self, signature) -> bool:
        """Deterministic trace-sampling decision: a content hash of
        (session seed, structural signature) against ``trace_sample`` (the
        reference's hash, bit for bit), so equal-seed sessions sample the
        same queries."""
        p = self.config.trace_sample
        if p <= 0.0:
            return False
        if p >= 1.0:
            return True
        h = _content_hash(self._entropy, 0x7E1E5C0F, signature)
        return (h / 2.0 ** 64) < p

    def template_key(self, sql: str) -> str:
        """The 12-hex time-series / SLO key of ``sql``'s constant-stripped
        template (what :class:`repro_torch.obs.slo.SloTarget.template` and
        the time-series key by): constant-varied re-issues of one dashboard
        query map to one key."""
        parsed = parse_sql(sql, max_groups_resolver=self.infer_max_groups,
                           spec_kwargs=self.config.spec_kwargs)
        return _trace.sig_hash(
            plan_template(structural_signature(parsed.query)))

    def _emit_event(self, etype: str, **fields) -> None:
        """Append one flight-recorder record (no-op when unarmed; the
        recorder itself never raises into the query path)."""
        if self.recorder is not None:
            self.recorder.emit(etype, **fields)

    def _observe_delivery(self, handle: QueryHandle) -> None:
        """The completion hook (``handle._on_complete``): one time-series
        row, the SLO evaluation and the flight-recorder terminal event of a
        just-finished handle.  Read-only over the handle; runs after the
        done event and never raises (the hook firer swallows)."""
        latency = max(0.0, time.perf_counter() - handle.t_submit)
        key = handle._template_key or "_unkeyed"
        rep = handle.report
        failed = handle.status == QueryStatus.FAILED
        fallback = bool(rep.fallback) if rep is not None else False
        pilot_wall = rep.pilot_time_s if rep is not None else 0.0
        if handle.cached or rep is None:
            scanned = 0  # a cache-served delivery scanned nothing now
        elif rep.fallback:
            scanned = rep.pilot_scanned_bytes + rep.exact_scanned_bytes
        else:
            scanned = rep.pilot_scanned_bytes + rep.final_scanned_bytes
        shared = bool(rep.pilot_shared) if rep is not None else False
        staged = False
        if handle._trace is not None:  # staged rungs tag scan spans only
            # a drain group's shared work is no one member's scan
            staged = any(sp.attrs.get("staged") for sp in handle._trace.find(
                "scan", skip=_trace.GROUP_SPANS))
        if self.timeseries is not None:
            self.timeseries.record_delivery(
                key, sql=handle.sql, latency_s=latency,
                pilot_wall_s=pilot_wall, scanned_bytes=scanned,
                cached=handle.cached, shared=shared, fused=handle._fused,
                staged=staged, fallback=fallback, failed=failed)
        if self.recorder is not None:
            if failed:
                self._emit_event("fail", qid=handle.query_id, template=key,
                                 latency_s=round(latency, 6),
                                 error=handle.error)
            else:
                self._emit_event(
                    "deliver", qid=handle.query_id, template=key,
                    latency_s=round(latency, 6),
                    pilot_wall_s=round(pilot_wall, 6),
                    scanned_bytes=int(scanned), cached=handle.cached,
                    shared=shared, fused=handle._fused, staged=staged,
                    fallback=fallback)
                if fallback:
                    self._emit_event("fallback", qid=handle.query_id,
                                     template=key, reason=rep.fallback)
        if handle._trace_sampled and handle._trace is not None:
            tree = handle._trace.to_dict()
            self.recent_traces.append(tree)
            self._emit_event("trace", qid=handle.query_id, template=key,
                             trace=tree)
        if self.slo is not None:
            self.slo.evaluate(key)

    def _observe_audit(self, handle: QueryHandle,
                       rec: _audit.AuditRecord) -> None:
        """Feed one audit outcome into the time-series, the recorder and
        the SLO monitor (called by :meth:`_complete_handle` after the
        auditor ran)."""
        key = handle._template_key or "_unkeyed"
        if self.timeseries is not None and rec.skipped is None:
            self.timeseries.record_audit(key, rec.error_ratio, rec.passed)
        self._emit_event("audit", qid=handle.query_id, template=key,
                         ratio=round(rec.error_ratio, 6), passed=rec.passed,
                         observed=round(rec.observed_error, 6),
                         promised=rec.promised_error, skipped=rec.skipped)
        if self.slo is not None and rec.skipped is None:
            self.slo.evaluate(key)  # violation-rate targets see the record

    # -- front doors ----------------------------------------------------------
    def table(self, name: str) -> QueryBuilder:
        """A fluent builder over table ``name`` (see :mod:`repro_torch.api.builder`)."""
        if name not in self.executor.catalog:
            raise KeyError(f"unknown table {name!r}; registered: "
                           f"{self.tables()}")
        return QueryBuilder(self, name)

    def sql(self, text: str, *, stream: bool = False) -> QueryHandle:
        """Parse and execute dialect SQL synchronously.

        Parse-stage rejections (:class:`repro_torch.api.SqlSyntaxError`,
        :class:`repro_torch.api.UnsupportedSqlError`) raise immediately;
        execution failures are captured on the returned handle.
        ``stream=True`` attaches a frame buffer before execution, so the
        handle's :meth:`QueryHandle.stream` / :meth:`QueryHandle.on_frame`
        observe the advisory pilot estimate as well as the terminal frame.
        """
        handle = self._parse_to_handle(text, stream=stream)
        self._run_handle(handle)
        return handle

    def prepare(self, text: str, *, stream: bool = False) -> QueryHandle:
        """Parse dialect SQL into a pending handle without scheduling it."""
        return self._parse_to_handle(text, stream=stream)

    def submit(self, text: str, *, stream: bool = False) -> QueryHandle:
        """Parse dialect SQL and queue it on the session scheduler; it runs
        at the next :meth:`drain`."""
        return self.scheduler.submit(self.prepare(text, stream=stream))

    def execute(self, query: Query, spec: Optional[ErrorSpec] = None, *,
                stream: bool = False) -> QueryHandle:
        """Execute an already-lowered query synchronously (the builder's
        ``run``)."""
        handle = self._make_handle(query, spec, stream=stream)
        self._run_handle(handle)
        return handle

    def submit_query(self, query: Query, spec: Optional[ErrorSpec] = None, *,
                     having: Optional[HavingClause] = None,
                     limit: Optional[LimitClause] = None,
                     stream: bool = False) -> QueryHandle:
        """Queue an already-lowered query on the session scheduler."""
        return self.scheduler.submit(
            self._make_handle(query, spec, having=having, limit=limit,
                              stream=stream))

    def drain(self, max_queries: Optional[int] = None) -> List[QueryHandle]:
        """Run the queued queries (see :class:`QueryScheduler`) and return
        their handles, finished, in fair admission order;
        ``scheduler.last_drain`` holds the drain's :class:`DrainStats`."""
        return self.scheduler.drain(max_queries)

    def drain_async(self) -> List[QueryHandle]:
        """Dispatch every queued query to the runtime without waiting;
        observe completion per handle via ``poll()`` / ``wait()``."""
        return self.scheduler.drain_async()

    # -- plumbing -------------------------------------------------------------
    def _parse_to_handle(self, text: str, *, stream: bool = False) -> QueryHandle:
        t0 = time.perf_counter()
        parsed = parse_sql(text, max_groups_resolver=self.infer_max_groups,
                           spec_kwargs=self.config.spec_kwargs)
        t_parsed = time.perf_counter()
        # t0 (before the parse) is the submit epoch: the parse span and
        # every frame's emitted_at stay non-negative relative to it
        handle = self._make_handle(parsed.query, parsed.spec, sql=text,
                                   having=parsed.having, limit=parsed.limit,
                                   stream=stream, t_submit=t0)
        if handle._trace is not None:
            handle._trace.record("parse", duration_s=t_parsed - t0)
        return handle

    def _resolve_dictionary(self, column: str, literal: str) -> int:
        d = self._dictionaries.get(column)
        if d is None:
            raise UnsupportedSqlError(
                f"string literal {literal!r} compares against {column!r}, "
                "which has no registered dictionary (see "
                "Session.register_dictionary)")
        if literal not in d.codes:
            raise UnsupportedSqlError(
                f"{literal!r} is not in the dictionary of {column!r} "
                f"(values: {sorted(d.codes)})")
        return d.codes[literal]

    def _resolve_dictionary_order(self, column: str, literal: str,
                                  op: str) -> Tuple[str, int]:
        """Lower an order comparison ``column <op> literal`` against a
        SORTED dictionary to an integer-code comparison (a bisection
        boundary, valid even for literals not in the dictionary)."""
        d = self._dictionaries.get(column)
        if d is None:
            raise UnsupportedSqlError(
                f"string literal {literal!r} compares against {column!r}, "
                "which has no registered dictionary (see "
                "Session.register_dictionary)")
        if not d.is_sorted:
            raise UnsupportedSqlError(
                f"dictionary-encoded column {column!r} supports = and != "
                f"only, got {op!r}: its dictionary is not lexicographically "
                "sorted, so code order does not reflect string order "
                "(register a sorted dictionary to enable order comparisons)")
        if op in ("<", ">="):
            boundary = bisect.bisect_left(d.values, literal)
        else:  # "<=", ">": strict/inclusive flip at the right bisection
            boundary = bisect.bisect_right(d.values, literal)
        lowered = {"<": "<", "<=": "<", ">": ">=", ">=": ">="}[op]
        return lowered, boundary

    def _validate_group_domain(self, query: Query) -> None:
        """Reject GROUP BY shapes that would silently misbehave: a
        max_groups above the buffer-size cap or below the column's observed
        domain."""
        if query.group_by is None:
            return
        limit = self.config.max_groups_limit
        if query.max_groups > limit:
            raise UnsupportedSqlError(
                f"GROUP BY {query.group_by}: max_groups={query.max_groups} "
                f"exceeds the session limit {limit} (per-block group "
                "buffers scale with max_groups)")
        tables = tuple(s.table for s in query.child.scans())
        domain = self.infer_max_groups(tables, query.group_by)
        if domain > query.max_groups:
            raise UnsupportedSqlError(
                f"GROUP BY {query.group_by}: MAXGROUPS {query.max_groups} "
                f"is below the observed group domain ({domain}); overflow "
                "groups would be silently merged into the last group")

    def _make_handle(self, query: Query, spec: Optional[ErrorSpec],
                     sql: Optional[str] = None,
                     having: Optional[HavingClause] = None,
                     limit: Optional[LimitClause] = None,
                     stream: bool = False,
                     t_submit: Optional[float] = None) -> QueryHandle:
        # resolve + validate before deriving a seed: rejected queries never
        # enter the seed keyspace
        query = resolve_string_literals(query, self._resolve_dictionary,
                                        self._resolve_dictionary_order)
        self._validate_group_domain(query)
        outputs = [c.name for c in query.aggs]
        if having is not None and having.agg not in outputs:
            raise UnsupportedSqlError(
                f"HAVING references unknown aggregate {having.agg!r} "
                f"(outputs: {outputs})")
        if limit is not None and limit.order_by is not None \
                and limit.order_by not in outputs:
            raise UnsupportedSqlError(
                f"ORDER BY references unknown aggregate {limit.order_by!r} "
                f"(outputs: {outputs})")
        t_lower0 = time.perf_counter()
        signature = structural_signature(query)
        handle = QueryHandle(query_id=self._next_id, query=query, spec=spec,
                             seed=self._derive_seed(query, spec), sql=sql,
                             having=having, limit=limit, signature=signature,
                             group_key=plan_template(signature),
                             t_submit=(time.perf_counter()
                                       if t_submit is None else t_submit))
        self._next_id += 1
        handle._trace_sampled = self._trace_sampled(signature)
        if self.config.tracing or handle._trace_sampled:
            handle._trace = _trace.QueryTrace(
                handle.query_id, sql=sql, t_start=handle.t_submit)
            handle._trace.record(
                "lower", duration_s=time.perf_counter() - t_lower0,
                seed=handle.seed,
                template=_trace.sig_hash(handle.group_key),
                signature=_trace.sig_hash(signature))
        if self._telemetry_armed:
            handle._template_key = _trace.sig_hash(handle.group_key)
            handle._on_complete = self._observe_delivery
            self._emit_event("submit", qid=handle.query_id,
                             template=handle._template_key, sql=sql,
                             sampled=handle._trace_sampled)
        if stream:
            handle.enable_streaming()
        return handle

    def failed_handle(self, sql: str, error: str) -> QueryHandle:
        """A pre-failed handle for a request that never parsed (a serving
        front uses it to reject one client's bad SQL without dropping the
        batch); it takes the next query id."""
        handle = QueryHandle(query_id=self._next_id, query=None, spec=None,
                             seed=0, sql=sql, status=QueryStatus.FAILED,
                             error=error)
        handle._done_event.set()
        self._next_id += 1
        return handle

    # -- execution core (shared by sql and the runtime workers) --------------
    def _cache_key(self, handle: QueryHandle):
        # (structural signature, predicate constants, ErrorSpec, seed): the
        # frozen Query embeds the first two and pins the aggregate names
        return (handle.query, handle.spec, handle.seed)

    def _deliver(self, handle: QueryHandle, answer: ApproxAnswer) -> ApproxAnswer:
        """The answer a client sees: HAVING, then [ORDER BY] LIMIT, applied
        to the base answer (never part of the plan, the seed or the cache
        key)."""
        if handle.having is not None:
            answer = handle.having.apply(answer)
        if handle.limit is not None:
            answer = handle.limit.apply(answer)
        return answer

    def _serve_cached(self, handle: QueryHandle) -> bool:
        """Answer ``handle`` from the result cache if possible: the values
        and the error report guaranteed when they were computed (still
        valid: register_table would have evicted the entry)."""
        if handle.query is None:
            return False
        with _trace.span("cache_lookup") as sp:
            entry = self.result_cache.get(self._cache_key(handle))
            sp.set(hit=entry is not None)
        if entry is None:
            return False
        if handle.streaming and isinstance(entry, CachedAnswer) \
                and entry.pilot is not None:
            # replay the pilot summary recorded at insert as an advisory
            # frame, so cached re-issues stream the same shape (pilot then
            # final); entries without one stream a single frame
            handle._emit(pilot_frame_for(handle.query_id, entry.pilot,
                                         from_cache=True))
        answer = entry.to_answer() if isinstance(entry, CachedAnswer) else entry
        handle._mark_done(self._deliver(handle, answer), cached=True)
        return True

    def _scan_generations(self, query: Query) -> Tuple[int, ...]:
        with self._gen_lock:
            return tuple(self._table_gen.get(s.table, 0)
                         for s in query.child.scans())

    def _complete_handle(self, handle: QueryHandle, answer: ApproxAnswer,
                         gen_snapshot: Optional[tuple] = None,
                         pilot_est=None) -> bool:
        """Finish a handle, guarding against mid-flight table replacement.

        If :meth:`register_table` replaced a scanned table after execution
        started (``gen_snapshot`` mismatch), the answer may be torn — pilot
        statistics of the old data scaling a final scan of the new — so its
        error report is no longer a guarantee: the handle fails with a
        retryable error instead.  The result-cache insert is guarded by the
        same check, under the cache lock.  Returns True when the handle
        completed with the answer.

        ``pilot_est`` (the query's advisory :class:`PilotEstimate`, when its
        pilot produced one) is recorded on the cache entry so cached
        re-issues replay a provisional frame (see :meth:`_serve_cached`).
        In audit mode the exact query runs after delivery, against the base
        answer (before HAVING / LIMIT), outside the result cache.
        """
        if gen_snapshot is not None \
                and gen_snapshot != self._scan_generations(handle.query):
            handle._mark_failed(
                "table replaced while the query was in flight "
                f"({sorted({s.table for s in handle.query.child.scans()})}); "
                "resubmit to run against the new data")
            return False
        self.result_cache.put(
            self._cache_key(handle),
            CachedAnswer.from_answer(answer, pilot=pilot_est),
            (s.table for s in handle.query.child.scans()),
            guard=None if gen_snapshot is None else
            (lambda: gen_snapshot == self._scan_generations(handle.query)))
        handle._mark_done(self._deliver(handle, answer))
        if self.auditor is not None:
            # after delivery (the trace is finished, so the exact run traces
            # nothing); the auditor never raises
            rec = self.auditor.check(handle, answer)
            if rec is not None and self._telemetry_armed:
                try:  # telemetry observes; it must never raise into delivery
                    self._observe_audit(handle, rec)
                except Exception:
                    pass
        return True

    def _run_fused(self, handle: QueryHandle) -> Optional[ApproxAnswer]:
        """The single-launch fused TAQA program for ``handle``: the answer
        (bitwise the two-stage path's, see :meth:`PilotDB.run_fused`), or
        None when the query's shape is outside the fused envelope, in which
        case the caller runs the two stages having executed nothing.

        Unlike the reference, which swallows every exception here and
        re-runs the query in two stages, nothing is caught: ``run_fused``
        states its envelope by returning None (an empty final sample takes
        ``run_final``'s exact fallback inside it), so a kernel that fails to
        build or launch, or a CUDA error, propagates and fails the handle
        (the ``fused`` span then closes with an error status)."""
        with _trace.span("fused") as sp:
            ans = self.db.run_fused(handle.query, handle.spec, seed=handle.seed,
                                    pilot_seed=self._pilot_seed_for(handle))
            sp.set(engaged=ans is not None,
                   fallback=None if ans is None else ans.report.fallback)
        if ans is not None:
            handle._fused = True  # provenance and telemetry read this flag
            rep = ans.report
            self._emit_event("pilot", qid=handle.query_id, fused=True,
                             table=rep.pilot_table,
                             scanned_bytes=rep.pilot_scanned_bytes,
                             wall_s=round(rep.pilot_time_s, 6),
                             fallback=rep.fallback)
            self._emit_event("rate_solve", qid=handle.query_id, fused=True,
                             candidates=rep.candidates, fallback=rep.fallback)
            self._emit_event("final", qid=handle.query_id, fused=True,
                             scanned_bytes=rep.final_scanned_bytes,
                             wall_s=round(rep.final_time_s, 6),
                             fallback=rep.fallback)
        return ans

    def _run_handle(self, handle: QueryHandle) -> QueryHandle:
        if handle.done:
            return handle
        token = _trace.activate(handle._trace)
        try:
            if self._serve_cached(handle):
                return handle
            handle._mark_running()
            gen = self._scan_generations(handle.query)
            try:
                pilot_est = None
                if handle.spec is None:
                    with _trace.span("exact") as sp:
                        ans = self.db.exact(handle.query)
                        sp.set(scanned_bytes=ans.report.exact_scanned_bytes)
                elif self.config.fused_taqa and (
                        fused := self._run_fused(handle)) is not None:
                    ans = fused
                else:
                    # the reference's two-stage branch: pilot, host rate
                    # solve, final — the same three calls, in the same
                    # order, each in its own span, so the advisory estimate
                    # streams the moment stage 1 returns
                    with _trace.span("pilot", shared=False) as sp:
                        outcome = self.db.run_pilot(
                            handle.query, handle.spec,
                            self._pilot_seed_for(handle))
                        rep = outcome.report
                        sp.set(table=rep.pilot_table,
                               theta_pilot=rep.theta_pilot,
                               n_pilot_blocks=rep.n_pilot_blocks,
                               scanned_bytes=rep.pilot_scanned_bytes,
                               fallback=rep.fallback)
                    self._emit_event(
                        "pilot", qid=handle.query_id, shared=False,
                        table=rep.pilot_table,
                        scanned_bytes=rep.pilot_scanned_bytes,
                        wall_s=round(rep.pilot_time_s, 6),
                        fallback=rep.fallback)
                    with _trace.span("advisory"):
                        pilot_est = advisory_estimate(handle.query, outcome,
                                                      handle.spec.confidence)
                    if pilot_est is not None:
                        handle._emit(pilot_frame_for(handle.query_id,
                                                     pilot_est))
                    with _trace.span("rate_solve") as sp:
                        stage = self.db.prepare_final(
                            handle.query, handle.spec, outcome, handle.seed)
                        rep = stage.report
                        sp.set(candidates=rep.candidates,
                               fallback=rep.fallback,
                               rates=dict(rep.plan.rates)
                               if rep.plan is not None else None)
                    self._emit_event("rate_solve", qid=handle.query_id,
                                     candidates=rep.candidates,
                                     fallback=rep.fallback)
                    with _trace.span("final", batched=False) as sp:
                        ans = self.db.run_final(stage)
                        sp.set(scanned_bytes=ans.report.final_scanned_bytes,
                               fallback=ans.report.fallback)
                    self._emit_event(
                        "final", qid=handle.query_id,
                        scanned_bytes=ans.report.final_scanned_bytes,
                        wall_s=round(ans.report.final_time_s, 6),
                        fallback=ans.report.fallback)
                with _trace.span("deliver"):
                    self._complete_handle(handle, ans, gen,
                                          pilot_est=pilot_est)
            except Exception as e:  # capture, don't raise through the client
                handle._mark_failed(f"{type(e).__name__}: {e}")
            return handle
        finally:
            # worker threads are pooled: a leaked context variable would
            # misattribute the next query's spans
            _trace.deactivate(token)

    def _execute_group(self, handles: List[QueryHandle]) -> None:
        """Run one signature group (runtime workers land here): cached
        members answer immediately, the rest share a pilot per
        pilot-params subgroup and finish independently."""
        _shared_pilot.execute_group(self, handles)
