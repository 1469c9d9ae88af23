"""Session — the stateful front door of the port (synchronous subset).

A :class:`Session` owns the registered tables (plus optional per-column
string dictionaries), the :class:`Executor` whose signature cache makes
repeated structurally-identical queries run warm, and deterministic seed
derivation.  ``session.sql(...)`` parses dialect SQL, runs TAQA's two
stages (pilot on the device → f64 rate solve on the host → final on the
device) and returns a :class:`QueryHandle` carrying status, the answer, the
:class:`TaqaReport` and any fallback reason.

Seed derivation is the reference's exactly: every query's sampling seed is
a pure function of ``(session seed, lowered query, ErrorSpec)`` and the
*pilot* seed of ``(session seed, structural signature, pilot-stage
tunables)``, both through ``blake2b(repr(parts))`` of the frozen plan and
spec dataclasses.  Equal-seed sessions of the two packages therefore draw
the same pilot and final blocks.

The session runs on the CUDA card by default and raises where there is
none; ``device="cpu"`` runs the kernels' plain PyTorch versions.  The
scheduler, concurrent runtime, result cache, staging, sharding, streaming
and observability hooks of the reference wait for later slices.
"""

from __future__ import annotations

import bisect
import dataclasses
import hashlib
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from repro_torch.api.sql import (HavingClause, LimitClause, UnsupportedSqlError,
                                 parse_sql, resolve_string_literals)
from repro_torch.core.spec import ErrorSpec
from repro_torch.core.taqa import (ApproxAnswer, PilotDB, Query, TaqaReport,
                                   pilot_params, structural_signature)
from repro_torch.device import resolve_device
from repro_torch.engine.executor import Executor
from repro_torch.engine.table import BlockTable


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
    _answer: Optional[ApproxAnswer] = None
    # full constant-bearing structural signature (pilot-seed derivation)
    signature: Optional[object] = dataclasses.field(
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

    def result(self) -> ApproxAnswer:
        """The answer; raises if the query failed or has not run yet."""
        if self.status == QueryStatus.FAILED:
            raise QueryFailedError(self.error or "query failed")
        if self._answer is None:
            raise RuntimeError(f"query {self.query_id} is {self.status}")
        return self._answer

    def scalar(self, name: str, group: int = 0) -> float:
        return self.result().scalar(name, group)


@dataclasses.dataclass(frozen=True)
class SessionConfig:
    large_table_rows: int = 50_000     # sampling threshold (§3.1)
    spec_kwargs: Optional[Dict] = None  # TAQA tunable overrides for SQL specs
    # The physical layer sizes dense per-(block, group) buffers by
    # max_groups; an id-cardinality GROUP BY would otherwise allocate
    # process-killing buffers in a shared server.
    max_groups_limit: int = 4096


class Session:
    """A client session against a catalog of block tables on one device."""

    def __init__(self, catalog: Optional[Dict[str, BlockTable]] = None, *,
                 seed: int = 0, config: SessionConfig = SessionConfig(),
                 device="cuda"):
        self.config = config
        self.device = resolve_device(device)
        if config.spec_kwargs:
            # fail at construction, not on every client's ERROR clause
            dataclasses.replace(ErrorSpec(error=0.05, confidence=0.95),
                                **config.spec_kwargs)
        self.executor = Executor(catalog or {}, device=self.device)
        self.db = PilotDB(self.executor,
                          large_table_rows=config.large_table_rows)
        self._entropy = int(seed)
        self._next_id = 0
        self._max_groups_cache: Dict[tuple, int] = {}
        self._dictionaries: Dict[str, _Dictionary] = {}

    # -- catalog -------------------------------------------------------------
    def register_table(self, name: str, table: BlockTable, *,
                       dictionaries: Optional[Dict[str, Sequence[str]]] = None,
                       ) -> None:
        """Add (or replace) a catalog table on this session's device.

        Registering ``name`` evicts the cached MAXGROUPS statistics of its
        columns.  ``dictionaries`` maps dictionary-encoded column names to
        their value lists (code = list index), enabling string literals for
        those columns in WHERE clauses.
        """
        self.executor.register_table(name, table)
        self._max_groups_cache = {k: v for k, v in
                                  self._max_groups_cache.items()
                                  if k[0] != name}
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

    # -- front doors ----------------------------------------------------------
    def sql(self, text: str) -> QueryHandle:
        """Parse and execute dialect SQL synchronously.

        Parse-stage rejections (:class:`repro_torch.api.SqlSyntaxError`,
        :class:`repro_torch.api.UnsupportedSqlError`) raise immediately;
        execution failures are captured on the returned handle.
        """
        parsed = parse_sql(text, max_groups_resolver=self.infer_max_groups,
                           spec_kwargs=self.config.spec_kwargs)
        handle = self._make_handle(parsed.query, parsed.spec, sql=text,
                                   having=parsed.having, limit=parsed.limit)
        self._run_handle(handle)
        return handle

    def execute(self, query: Query,
                spec: Optional[ErrorSpec] = None) -> QueryHandle:
        """Execute an already-lowered query synchronously."""
        handle = self._make_handle(query, spec)
        self._run_handle(handle)
        return handle

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
        handle = QueryHandle(query_id=self._next_id, query=query, spec=spec,
                             seed=self._derive_seed(query, spec), sql=sql,
                             having=having, limit=limit,
                             signature=structural_signature(query))
        self._next_id += 1
        return handle

    def _run_handle(self, handle: QueryHandle) -> QueryHandle:
        if handle.done:
            return handle
        handle.status = QueryStatus.RUNNING
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
            if handle.having is not None:
                ans = handle.having.apply(ans)
            if handle.limit is not None:   # after HAVING, as in the reference
                ans = handle.limit.apply(ans)
            handle._answer = ans
            handle.status = QueryStatus.DONE
        except Exception as e:  # capture, don't raise through the client
            handle.status = QueryStatus.FAILED
            handle.error = f"{type(e).__name__}: {e}"
        return handle
