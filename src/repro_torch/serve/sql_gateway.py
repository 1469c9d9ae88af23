"""Multi-client SQL gateway over one Session — the AQP serving front.

The reference's ``serve/sql_gateway.py`` on the port's ``Session``,
``QueryScheduler``, ``BackpressureError`` and ``stream.Frame``; host code
only (the queries' device work runs inside the session's drains).

Mirrors :class:`repro_torch.serve.engine.ServeEngine`'s submit/run idiom for the
query side of the house: many clients post dialect SQL, the gateway parses
each request immediately (a client's syntax error fails only that client's
ticket, never the batch) and enqueues the rest on its scheduler.  ``run()``
drains in signature-grouped, submission-fair batches through the session's
concurrent runtime — a thundering herd of structurally identical dashboard
queries compiles once, runs ONE shared pilot, and repeated identical
requests answer straight from the session result cache — the paper's
middleware stance (§2.4) at serving scale.

Backpressure.  Admission is bounded two ways, both raising
:class:`repro_torch.runtime.BackpressureError` *before* a ticket exists (the
request is refused, not failed — the client retries after results drain):

* ``max_pending`` caps this gateway's total unfinished admitted work —
  queries still queued AND queries in flight on runtime workers (work
  admitted by other gateways or direct session drains never consumes this
  gateway's budget);
* ``max_inflight_per_client`` caps one client's share of it, so a single
  dashboard storm cannot monopolize the admission queue.

Frame queues.  ``max_frames_per_client`` bounds the ADVISORY frames a
streaming client's queue holds, not its terminal frames: a terminal frame
(final, exact or error; one per ticket) is always appended, past the bound
if need be, so a queue holds at most the bound plus that client's
undelivered tickets.  Only an advisory arrival at a full queue evicts, and
it evicts the oldest advisory frame resident; when every resident frame is
terminal, the advisory newcomer itself is dropped.  Frames land in the
order the runtime emits them, so which frame an eviction hits depends on
how the drain interleaves the tickets' stages.
"""

from __future__ import annotations

import dataclasses
import itertools
import threading
from collections import deque
from typing import Deque, Dict, List, Optional, Tuple

from repro_torch.api.scheduler import QueryScheduler
from repro_torch.api.session import QueryHandle, Session
from repro_torch.obs import slo as _slo
from repro_torch.obs import timeseries as _timeseries
from repro_torch.runtime import BackpressureError
from repro_torch.stream import Frame


@dataclasses.dataclass
class GatewayStats:
    requests: int = 0
    rejected: int = 0          # failed at parse, never scheduled
    throttled: int = 0         # refused admission (backpressure), no ticket
    served: int = 0
    drains: int = 0
    compile_misses: int = 0
    compile_hits: int = 0
    pilots_run: int = 0        # pilot stages executed on behalf of this gateway
    result_hits: int = 0       # tickets answered from the session result cache
    streams: int = 0           # tickets admitted via submit_streaming
    frames_pushed: int = 0     # frames landed in client queues
    frames_dropped: int = 0    # advisory frames evicted by the queue bound

    @property
    def cache_hit_rate(self) -> float:
        total = self.compile_hits + self.compile_misses
        return self.compile_hits / total if total else 0.0

    def as_dict(self) -> Dict[str, object]:
        out = dataclasses.asdict(self)
        out["cache_hit_rate"] = self.cache_hit_rate
        return out


# Distinguishes collector names when several gateways share one session's
# metrics registry (each gateway keeps separate GatewayStats).
_GATEWAY_SEQ = itertools.count()


class SqlGateway:
    def __init__(self, session: Session, *, batch_size: Optional[int] = None,
                 max_pending: Optional[int] = None,
                 max_inflight_per_client: Optional[int] = None,
                 max_frames_per_client: int = 1024):
        if batch_size is not None and batch_size < 1:
            raise ValueError(f"batch_size must be >= 1, got {batch_size}")
        if max_pending is not None and max_pending < 1:
            raise ValueError(f"max_pending must be >= 1, got {max_pending}")
        if max_inflight_per_client is not None and max_inflight_per_client < 1:
            raise ValueError(f"max_inflight_per_client must be >= 1, "
                             f"got {max_inflight_per_client}")
        if max_frames_per_client < 1:
            raise ValueError(f"max_frames_per_client must be >= 1, "
                             f"got {max_frames_per_client}")
        self.session = session
        self.batch_size = batch_size
        self.max_pending = max_pending
        self.max_inflight_per_client = max_inflight_per_client
        self.max_frames_per_client = max_frames_per_client
        # A private scheduler over the shared session: draining this gateway
        # never executes (or counts) queries submitted elsewhere on the
        # session, and two gateways over one session keep separate stats.
        self.scheduler = QueryScheduler(session)
        self.stats = GatewayStats()
        # Expose this gateway's counters through the session's metrics
        # registry: the collector holds the gateway only weakly (owner), so
        # a dropped gateway disappears from scrapes instead of leaking.
        self._collector_name = f"gateway_{next(_GATEWAY_SEQ)}"
        session.metrics.register_collector(
            self._collector_name, self.stats.as_dict, owner=self)
        self._tickets: Dict[int, Tuple[str, QueryHandle]] = {}
        # per-client bounded frame queues (submit_streaming tickets push
        # here from runtime workers; frames_for drains on the client's turn)
        self._frames: Dict[str, Deque[Frame]] = {}
        self._frame_lock = threading.Lock()

    # -- admission control ----------------------------------------------------
    def _admitted_load(self) -> int:
        """THIS gateway's admitted work still queued or executing (tickets
        whose handles are not done — queued requests are ticketed at
        submission).  Other gateways / direct session drains sharing the
        runtime never consume this gateway's admission budget."""
        return sum(1 for _, h in self._tickets.values() if not h.done)

    def _check_admission(self, client_id: str) -> None:
        if (self.max_pending is not None
                and self._admitted_load() >= self.max_pending):
            self.stats.throttled += 1
            raise BackpressureError(
                f"admission queue full ({self.max_pending} pending); "
                "drain results (run()) and retry")
        if self.max_inflight_per_client is not None:
            mine = sum(1 for cid, h in self._tickets.values()
                       if cid == client_id and not h.done)
            if mine >= self.max_inflight_per_client:
                self.stats.throttled += 1
                raise BackpressureError(
                    f"client {client_id!r} has {mine} queries in flight "
                    f"(cap {self.max_inflight_per_client}); collect results "
                    "and retry")

    # -- client API -----------------------------------------------------------
    def submit(self, client_id: str, sql: str) -> int:
        """Post one client request; returns a ticket (the query id).

        Raises :class:`BackpressureError` when admission bounds are hit —
        the request was never admitted and no ticket exists.
        """
        self._check_admission(client_id)
        self.stats.requests += 1
        try:
            handle = self.scheduler.submit(self.session.prepare(sql))
        except (ValueError, RecursionError) as e:
            # ValueError covers SqlSyntaxError/UnsupportedSqlError (both
            # subclass it); anything else — an internal bug — propagates
            # loudly instead of being blamed on the client.
            # one client's unparseable request (including pathological
            # inputs like a parser-depth-busting predicate chain) fails
            # only that ticket, never the batch
            handle = self.session.failed_handle(sql, f"{type(e).__name__}: {e}")
            self.stats.rejected += 1
        self._tickets[handle.query_id] = (client_id, handle)
        return handle.query_id

    # -- progressive streaming ------------------------------------------------
    def _push_client_frame(self, client_id: str, frame: Frame) -> None:
        """Land one frame in ``client_id``'s bounded queue (runtime-worker
        side).  On overflow the OLDEST ADVISORY frame is evicted — advisory
        estimates are superseded by newer ones, so dropping stale ones loses
        nothing a client is owed; terminal frames are never dropped (their
        count is already bounded by the admission caps: one per ticket)."""
        with self._frame_lock:
            q = self._frames.setdefault(client_id, deque())
            if frame.advisory and len(q) >= self.max_frames_per_client:
                for i, old in enumerate(q):
                    if old.advisory:
                        del q[i]
                        break
                else:  # all resident frames terminal: drop the newcomer
                    self.stats.frames_dropped += 1
                    return
                self.stats.frames_dropped += 1
            q.append(frame)
            self.stats.frames_pushed += 1

    def submit_streaming(self, client_id: str, sql: str) -> int:
        """Post one client request as a STREAMING ticket: same admission,
        parsing, and scheduling as :meth:`submit`, but every frame of the
        query — the advisory pilot estimate(s) and the terminal frame — is
        additionally pushed to ``client_id``'s bounded frame queue, drained
        with :meth:`frames_for`.  The terminal FinalFrame carries the very
        answer object the ticket's handle delivers, so collecting frames
        instead of handles never changes an answer.
        """
        self._check_admission(client_id)
        self.stats.requests += 1
        try:
            handle = self.scheduler.submit(
                self.session.prepare(sql, stream=True))
        except (ValueError, RecursionError) as e:
            # same parse-failure capture as submit(); enabling streaming on
            # the pre-failed handle synthesizes its terminal ErrorFrame, so
            # the client's frame queue still sees the stream end
            handle = self.session.failed_handle(sql, f"{type(e).__name__}: {e}")
            self.stats.rejected += 1
        self.stats.streams += 1
        handle.on_frame(lambda f: self._push_client_frame(client_id, f))
        self._tickets[handle.query_id] = (client_id, handle)
        return handle.query_id

    def frames_for(self, client_id: str,
                   max_frames: Optional[int] = None) -> List[Frame]:
        """Drain up to ``max_frames`` of ``client_id``'s queued frames (all
        of them by default), oldest first.  Frames are delivered once."""
        with self._frame_lock:
            q = self._frames.get(client_id)
            if not q:
                return []
            n = len(q) if max_frames is None else min(max_frames, len(q))
            return [q.popleft() for _ in range(n)]

    def run(self) -> Dict[int, QueryHandle]:
        """Drain every scheduled request; returns ticket -> finished handle.

        Only *this round's* results are returned: delivered tickets are
        pruned, so a long-lived submit/run loop neither re-delivers stale
        answers nor accumulates every answer ever served.
        """
        while self.scheduler.pending_count:
            done = self.scheduler.drain(self.batch_size)
            self.stats.drains += 1
            self.stats.served += len(done)
            drain = self.scheduler.last_drain
            self.stats.compile_misses += drain.compile_misses
            self.stats.compile_hits += drain.compile_hits
            self.stats.pilots_run += drain.pilots_run
            self.stats.result_hits += drain.result_hits
        delivered = {qid: h for qid, (_, h) in self._tickets.items()
                     if h.done}
        for qid in delivered:
            del self._tickets[qid]
        return delivered

    def stats_payload(self) -> Dict[str, object]:
        """One serving-stats payload — a VIEW over the session's metrics
        registry (:meth:`repro_torch.obs.MetricsRegistry.tree`) plus this
        gateway's own request counters.  The key schema below is PINNED
        (tests/test_torch_gateway.py asserts it recursively); new keys are additive
        only, existing keys never change type or disappear.

        * ``gateway``       — the per-gateway :class:`GatewayStats` counters:
          ``requests`` / ``rejected`` (parse failures) / ``throttled``
          (backpressure refusals) / ``served`` / ``drains`` /
          ``compile_misses`` / ``compile_hits`` / ``pilots_run`` /
          ``result_hits`` / ``streams`` / ``frames_pushed`` /
          ``frames_dropped`` / derived ``cache_hit_rate``;
        * ``compile_cache`` — :meth:`repro_torch.engine.Executor.compile_cache_info`
          (``hits`` / ``misses`` / ``size`` resident callables plus
          ``staged_hits`` / ``staged_misses``, session-global); the grand
          totals additionally break out per path as ``pilot_hits`` /
          ``pilot_misses`` (solo and batched pilot lowerings),
          ``batched_hits`` / ``batched_misses`` (drain-group batch
          callables), ``fused_hits`` / ``fused_misses`` (single-launch
          fused TAQA programs), and ``shared_hits`` (local misses whose
          build was adopted from a same-geometry dist shard);
        * ``result_cache``  — result-cache ``hits`` / ``misses`` /
          ``evictions`` / ``invalidations`` / ``size`` / ``capacity`` AND
          byte counters ``bytes_used`` / ``max_bytes`` / derived
          ``hit_rate`` (session-global);
        * ``shard_scanned_bytes`` — per-shard sampled-slab byte attribution
          per partitioned table (``repro_torch.dist``), empty when nothing is
          sharded;
        * ``staged``        — the materialized sample-catalog state
          (:meth:`repro_torch.engine.Executor.staged_info`: ``hits`` / ``misses``
          / ``evictions`` counters, ``resident_bytes`` / ``max_bytes``,
          per-table ladders under ``tables``).  ALWAYS present with the
          full key schema — a session with no ladders (or an executor
          without a staged catalog) reports zero counters and empty
          ``tables``, so payload consumers never key-check;
        * ``runtime``       — async-runtime totals (``workers`` /
          ``pilot_workers`` / ``in_flight`` / ``groups_total`` / pilot
          fan-out counters) plus executor ``queries_run`` / ``pilots_run``;
        * ``audit``         — guarantee-auditor summary (``runs`` /
          ``violations`` / ``errors`` / ``max_error_ratio``; zeros when
          :attr:`SessionConfig.audit` is off);
        * ``timeseries``    — the per-template time-series snapshot
          (:meth:`repro_torch.obs.TemplateTimeSeries.snapshot`: windowed
          p50/p95/p99 rings per template plus drain TTFF/TTF rings;
          ``enabled`` False with empty ``templates`` when
          :attr:`SessionConfig.telemetry` is off);
        * ``slo``           — the SLO-monitor summary
          (:meth:`repro_torch.obs.SloMonitor.summary`: target count, breach
          totals, recent breaches; ``enabled`` False when telemetry is
          off).
        """
        tree = self.session.metrics.tree()
        # pinned payload schema: merge the registry's staged snapshot over a
        # full-key skeleton (duck-typed executors may lack staged_info)
        staged_info = {"hits": 0, "misses": 0, "evictions": 0,
                       "resident_bytes": 0, "max_bytes": None, "tables": {}}
        staged_info.update(tree.get("staged") or {})
        audit_info = {"runs": 0, "violations": 0, "errors": 0,
                      "max_error_ratio": 0.0}
        audit_info.update(tree.get("audit") or {})
        ts_info = _timeseries.empty_snapshot()
        ts_info.update(tree.get("timeseries") or {})
        slo_info = _slo.empty_summary()
        slo_info.update(tree.get("slo") or {})
        return {
            "gateway": self.stats.as_dict(),
            "compile_cache": tree.get("compile_cache") or {},
            "result_cache": tree.get("result_cache") or {},
            "shard_scanned_bytes": tree.get("shard_scanned_bytes") or {},
            "staged": staged_info,
            "runtime": tree.get("runtime") or {},
            "audit": audit_info,
            "timeseries": ts_info,
            "slo": slo_info,
        }

    def slo_report(self) -> List[Dict[str, object]]:
        """Current state of every configured SLO rule against its template's
        windowed statistics — one row per (rule, matching template) pair
        with the observed value, the target, and whether it is breached NOW
        (see :meth:`repro_torch.obs.SloMonitor.report`).  Empty when the session
        has no SLO monitor (``telemetry`` off or no targets)."""
        slo = getattr(self.session, "slo", None)
        return slo.report() if slo is not None else []

    def metrics_text(self) -> str:
        """The session's full metrics registry — first-class instruments
        plus every live collector snapshot (this gateway's counters
        included) — rendered in Prometheus text exposition format."""
        return self.session.metrics.to_text()

    def results_for(self, client_id: str) -> List[QueryHandle]:
        """This client's not-yet-delivered handles (pending or undelivered
        failures); answers already returned by ``run()`` are pruned."""
        return [h for cid, h in self._tickets.values() if cid == client_id]
