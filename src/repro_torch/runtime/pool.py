"""Thread-pool execution of drain groups — async behind QueryHandle.

A kernel launch and the device→host copy that ends each stage release the
GIL while the card works, so a thread pool overlaps one group's host work
(sampling draws, rate solves) with another group's device work.  Groups,
not single queries, are the unit of work: a group shares its pilots (see
``shared_pilot``) and stays on one worker so its members finish from the
same outcomes without a hand-off between threads.

Every failure is captured on the affected handles (``shared_pilot`` per
member, a last-resort net here for faults of the group machinery itself
and for a failing batched launch) — nothing raises through ``run_groups``
and no worker death loses a handle.  The same capture path closes every
*streaming* handle's frame stream with a terminal
:class:`repro_torch.stream.ErrorFrame` (``QueryHandle._mark_failed`` emits
it), so a blocked ``stream()`` iterator always terminates.

Backpressure is the admission side's job: :class:`BackpressureError` is for
callers that bound ``in_flight`` plus their queue; the pool itself never
drops or blocks submissions.
"""

from __future__ import annotations

import threading
from concurrent.futures import Future, ThreadPoolExecutor, wait
from typing import TYPE_CHECKING, List, Optional

if TYPE_CHECKING:
    from repro_torch.api.session import QueryHandle, Session


class BackpressureError(RuntimeError):
    """Admission refused: the queue is full or a per-client cap is hit.

    Deliberately NOT a query failure — the request was never admitted, so
    no ticket exists and no seed was consumed; the client should retry
    after draining results.
    """


class AsyncRuntime:
    """Executes drain groups on a bounded worker pool for one session.

    Two pools, deliberately separate: the GROUP pool runs whole drain
    groups, and the PILOT pool fans one group's pilot-sharing *subgroups*
    out concurrently.  Group workers block on pilot futures; the pilot pool
    never submits back to the group pool, so the fan-out cannot deadlock
    however saturated either pool is.
    """

    def __init__(self, session: "Session", workers: int = 4,
                 pilot_workers: int = 0):
        if workers < 0:
            raise ValueError(f"workers must be >= 0, got {workers}")
        if pilot_workers < 0:
            raise ValueError(
                f"pilot_workers must be >= 0, got {pilot_workers}")
        self._session = session
        self.workers = workers
        self.pilot_workers = pilot_workers
        self._pool: Optional[ThreadPoolExecutor] = None
        self._pilot_pool: Optional[ThreadPoolExecutor] = None
        self._lock = threading.Lock()
        self._in_flight = 0          # handles dispatched, not yet finished
        self._futures: List[Future] = []
        self.total_groups = 0
        # pilot fan-out accounting (scheduler drains diff these): wall is
        # the concurrent span, serial the sum of the per-subgroup stage
        # durations it overlapped
        self.pilot_fanouts = 0
        self.pilot_fanout_wall_s = 0.0
        self.pilot_fanout_serial_s = 0.0

    @property
    def is_async(self) -> bool:
        return self.workers > 0

    @property
    def in_flight(self) -> int:
        """Handles currently dispatched to workers and not yet finished —
        the admission-control signal a serving front bounds against."""
        with self._lock:
            return self._in_flight

    def _ensure_pool(self) -> ThreadPoolExecutor:
        with self._lock:
            if self._pool is None:
                self._pool = ThreadPoolExecutor(
                    max_workers=self.workers,
                    thread_name_prefix="pilotdb-runtime")
            return self._pool

    def _ensure_pilot_pool(self) -> ThreadPoolExecutor:
        with self._lock:
            if self._pilot_pool is None:
                self._pilot_pool = ThreadPoolExecutor(
                    max_workers=self.pilot_workers,
                    thread_name_prefix="pilotdb-pilot")
            return self._pilot_pool

    # -- pilot-subgroup fan-out ----------------------------------------------
    def map_pilot_subgroups(self, fn, items: list) -> list:
        """Run ``fn`` over a drain group's pilot subgroups, concurrently on
        the pilot pool when it exists, and return results in input order.
        ``fn`` captures per-member failures itself (shared_pilot does)."""
        if self.pilot_workers <= 1 or len(items) <= 1:
            return [fn(x) for x in items]
        pool = self._ensure_pilot_pool()
        return [f.result() for f in [pool.submit(fn, x) for x in items]]

    def record_pilot_fanout(self, wall_s: float, serial_s: float) -> None:
        with self._lock:
            self.pilot_fanouts += 1
            self.pilot_fanout_wall_s += wall_s
            self.pilot_fanout_serial_s += serial_s

    def pilot_fanout_totals(self):
        with self._lock:
            return (self.pilot_fanouts, self.pilot_fanout_wall_s,
                    self.pilot_fanout_serial_s)

    def totals(self) -> dict:
        """One consistent snapshot of the runtime's cumulative counters —
        the metrics registry's ``runtime`` collector reads this."""
        with self._lock:
            return {
                "workers": self.workers,
                "pilot_workers": self.pilot_workers,
                "in_flight": self._in_flight,
                "groups_total": self.total_groups,
                "pilot_fanouts": self.pilot_fanouts,
                "pilot_fanout_wall_s": self.pilot_fanout_wall_s,
                "pilot_fanout_serial_s": self.pilot_fanout_serial_s,
            }

    # -- execution -----------------------------------------------------------
    def run_groups(self, groups: List[List["QueryHandle"]],
                   block: bool = True) -> None:
        """Execute signature groups; with ``block=False`` they run in the
        background and callers observe completion via handle.poll()/wait()."""
        groups = [g for g in groups if g]
        if not groups:
            return
        with self._lock:
            self.total_groups += len(groups)
        if not self.is_async:
            for g in groups:
                self._run_group_captured(g)
            return
        pool = self._ensure_pool()
        futures = []
        for g in groups:
            with self._lock:
                self._in_flight += len(g)
            futures.append(pool.submit(self._worker, g))
        with self._lock:
            self._futures = [f for f in self._futures if not f.done()]
            self._futures.extend(futures)
        if block:
            for f in futures:
                f.result()  # re-raises only what the capture let through

    def wait_idle(self, timeout: Optional[float] = None) -> bool:
        """Block until every dispatched group finished; False on timeout."""
        with self._lock:
            outstanding = list(self._futures)
        _, not_done = wait(outstanding, timeout=timeout)
        with self._lock:
            self._futures = [f for f in self._futures if not f.done()]
        return not not_done

    def shutdown(self) -> None:
        with self._lock:
            pool, self._pool = self._pool, None
            pilot_pool, self._pilot_pool = self._pilot_pool, None
        if pool is not None:
            pool.shutdown(wait=True)
        if pilot_pool is not None:
            pilot_pool.shutdown(wait=True)

    # -- worker side ---------------------------------------------------------
    def _worker(self, group: List["QueryHandle"]) -> None:
        try:
            self._run_group_captured(group)
        finally:
            with self._lock:
                self._in_flight -= len(group)

    def _run_group_captured(self, group: List["QueryHandle"]) -> None:
        try:
            self._session._execute_group(group)
        except Exception as e:  # fail the group's handles, not the pool
            for h in group:
                if not h.done:
                    h._mark_failed(
                        f"runtime worker error: {type(e).__name__}: {e}")
