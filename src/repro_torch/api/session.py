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
runs the kernels' plain PyTorch versions.  The fused, streaming and
observability hooks of the reference wait for later slices.
"""

from __future__ import annotations

import bisect
import dataclasses
import hashlib
import os
import threading
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from repro_torch.api.builder import QueryBuilder
from repro_torch.api.scheduler import QueryScheduler
from repro_torch.api.sql import (HavingClause, LimitClause, UnsupportedSqlError,
                                 parse_sql, resolve_string_literals)
from repro_torch.core.spec import ErrorSpec
from repro_torch.core.taqa import (ApproxAnswer, PilotDB, Query, TaqaReport,
                                   pilot_params, structural_signature)
from repro_torch.device import resolve_device
from repro_torch.dist import DistExecutor
from repro_torch.engine.executor import Executor
from repro_torch.engine.physical import plan_template
from repro_torch.engine.staged import DEFAULT_STAGED_RATES, validate_rates
from repro_torch.engine.table import BlockTable
from repro_torch.runtime import shared_pilot as _shared_pilot
from repro_torch.runtime.pool import AsyncRuntime
from repro_torch.runtime.result_cache import (CachedAnswer, ResultCache,
                                              ResultCacheInfo)


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

    # -- completion (runtime-internal) ----------------------------------------
    def _mark_running(self) -> None:
        if not self.done:
            self.status = QueryStatus.RUNNING

    def _mark_done(self, answer: ApproxAnswer, cached: bool = False) -> None:
        self._answer = answer
        self.cached = cached
        self.status = QueryStatus.DONE
        self._done_event.set()

    def _mark_failed(self, error: str) -> None:
        self.status = QueryStatus.FAILED
        self.error = error
        self._done_event.set()

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
    # fanned out to every member, and the group's same-bucket finals run as
    # ONE batched kernel launch (off: each query runs its own pilot and its
    # own final launch, bitwise equal).  Never shared across predicate
    # constants.
    share_pilots: bool = True
    # Worker threads fanning a drain group's pilot SUBGROUPS out; separate
    # from the group pool, so group workers waiting on them cannot deadlock
    # it.  0 (the default) runs them one after another on the group's
    # worker: the rate solves and host draws hold the GIL, and threads
    # fanning them out made the H100 host's drain slower, not faster.
    pilot_workers: int = 0
    # Session result-cache capacity in answers; 0 disables caching.
    result_cache_size: int = 128
    # Optional byte budget for the staged sample catalog (tables registered
    # with staged_rates=...): rung tensors of cold ladders are evicted
    # LRU-first past the budget; the ladder's pinned staging seed survives
    # eviction, so answers stay bitwise equal across the hit/miss boundary.
    # None = unbounded residency.
    staged_bytes: Optional[int] = None

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
        self.result_cache = ResultCache(config.result_cache_size)
        self.runtime = AsyncRuntime(self, workers=config.resolve_workers(),
                                    pilot_workers=config.pilot_workers)
        self.scheduler = QueryScheduler(self)

    def close(self) -> None:
        """Shut the runtime's worker pools down (idempotent)."""
        self.runtime.shutdown()

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
        ranges: block-sampled scans then run one dispatch per shard, merged
        through per-block statistics (:mod:`repro_torch.dist`), and answers
        are bitwise equal for EVERY shard count.  ``None`` (default)
        registers it whole.  A sharded registration keeps the whole table
        (exact, row-sample and multi-table paths run on it) AND a copy of
        every shard's slice: about twice the table's bytes on the device.

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

    # -- front doors ----------------------------------------------------------
    def table(self, name: str) -> QueryBuilder:
        """A fluent builder over table ``name`` (see :mod:`repro_torch.api.builder`)."""
        if name not in self.executor.catalog:
            raise KeyError(f"unknown table {name!r}; registered: "
                           f"{self.tables()}")
        return QueryBuilder(self, name)

    def sql(self, text: str) -> QueryHandle:
        """Parse and execute dialect SQL synchronously.

        Parse-stage rejections (:class:`repro_torch.api.SqlSyntaxError`,
        :class:`repro_torch.api.UnsupportedSqlError`) raise immediately;
        execution failures are captured on the returned handle.
        """
        handle = self.prepare(text)
        self._run_handle(handle)
        return handle

    def prepare(self, text: str) -> QueryHandle:
        """Parse dialect SQL into a pending handle without scheduling it."""
        parsed = parse_sql(text, max_groups_resolver=self.infer_max_groups,
                           spec_kwargs=self.config.spec_kwargs)
        return self._make_handle(parsed.query, parsed.spec, sql=text,
                                 having=parsed.having, limit=parsed.limit)

    def submit(self, text: str) -> QueryHandle:
        """Parse dialect SQL and queue it on the session scheduler; it runs
        at the next :meth:`drain`."""
        return self.scheduler.submit(self.prepare(text))

    def execute(self, query: Query,
                spec: Optional[ErrorSpec] = None) -> QueryHandle:
        """Execute an already-lowered query synchronously (the builder's
        ``run``)."""
        handle = self._make_handle(query, spec)
        self._run_handle(handle)
        return handle

    def submit_query(self, query: Query, spec: Optional[ErrorSpec] = None, *,
                     having: Optional[HavingClause] = None,
                     limit: Optional[LimitClause] = None) -> QueryHandle:
        """Queue an already-lowered query on the session scheduler."""
        return self.scheduler.submit(
            self._make_handle(query, spec, having=having, limit=limit))

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
                     limit: Optional[LimitClause] = None) -> QueryHandle:
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
        signature = structural_signature(query)
        handle = QueryHandle(query_id=self._next_id, query=query, spec=spec,
                             seed=self._derive_seed(query, spec), sql=sql,
                             having=having, limit=limit, signature=signature,
                             group_key=plan_template(signature))
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
        entry = self.result_cache.get(self._cache_key(handle))
        if entry is None:
            return False
        answer = entry.to_answer() if isinstance(entry, CachedAnswer) else entry
        handle._mark_done(self._deliver(handle, answer), cached=True)
        return True

    def _scan_generations(self, query: Query) -> Tuple[int, ...]:
        with self._gen_lock:
            return tuple(self._table_gen.get(s.table, 0)
                         for s in query.child.scans())

    def _complete_handle(self, handle: QueryHandle, answer: ApproxAnswer,
                         gen_snapshot: Optional[tuple] = None) -> bool:
        """Finish a handle, guarding against mid-flight table replacement.

        If :meth:`register_table` replaced a scanned table after execution
        started (``gen_snapshot`` mismatch), the answer may be torn — pilot
        statistics of the old data scaling a final scan of the new — so its
        error report is no longer a guarantee: the handle fails with a
        retryable error instead.  The result-cache insert is guarded by the
        same check, under the cache lock.  Returns True when the handle
        completed with the answer.
        """
        if gen_snapshot is not None \
                and gen_snapshot != self._scan_generations(handle.query):
            handle._mark_failed(
                "table replaced while the query was in flight "
                f"({sorted({s.table for s in handle.query.child.scans()})}); "
                "resubmit to run against the new data")
            return False
        self.result_cache.put(
            self._cache_key(handle), CachedAnswer.from_answer(answer),
            (s.table for s in handle.query.child.scans()),
            guard=None if gen_snapshot is None else
            (lambda: gen_snapshot == self._scan_generations(handle.query)))
        handle._mark_done(self._deliver(handle, answer))
        return True

    def _run_handle(self, handle: QueryHandle) -> QueryHandle:
        if handle.done:
            return handle
        if self._serve_cached(handle):
            return handle
        handle._mark_running()
        gen = self._scan_generations(handle.query)
        try:
            if handle.spec is None:
                ans = self.db.exact(handle.query)
            else:
                # the reference's two-stage branch: pilot, host rate solve,
                # final — the same three calls, in the same order
                outcome = self.db.run_pilot(handle.query, handle.spec,
                                            self._pilot_seed_for(handle))
                stage = self.db.prepare_final(handle.query, handle.spec,
                                              outcome, handle.seed)
                ans = self.db.run_final(stage)
            self._complete_handle(handle, ans, gen)
        except Exception as e:  # capture, don't raise through the client
            handle._mark_failed(f"{type(e).__name__}: {e}")
        return handle

    def _execute_group(self, handles: List[QueryHandle]) -> None:
        """Run one signature group (runtime workers land here): cached
        members answer immediately, the rest share a pilot per
        pilot-params subgroup and finish independently."""
        _shared_pilot.execute_group(self, handles)
