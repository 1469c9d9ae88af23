"""Per-template time-series: bounded rings with streaming windowed quantiles.

Point-in-time snapshots (``stats_payload()``) answer "what is the state
now"; this module answers "how has template X behaved over the last N
deliveries".  A :class:`TemplateTimeSeries` keys bounded :class:`Ring`
buffers by the constant-stripped *template* signature hash (the scheduler's
grouping key, ``trace.sig_hash(handle.group_key)``) and records one row per
DELIVERY — latency, pilot wall, scanned bytes, provenance flags (cached /
shared / fused / staged / fallback / failed) and, when audit mode runs, the
observed/promised error ratio — exposing streaming windowed p50/p95/p99
quantiles per field.

Wiring.  The session's delivery hook (:meth:`Session._observe_delivery`)
feeds the store on every ``_mark_done`` / ``_mark_failed``; scheduler
drains feed the streaming latency rings (:meth:`record_drain`).  The store
registers as a ``timeseries`` collector on the session's
:class:`MetricsRegistry`, so the quantiles flow through ``tree()``,
``stats_payload()["timeseries"]`` and ``metrics_text()`` with no extra
plumbing.  The flight recorder (:mod:`repro_torch.obs.events`) logs the same
rows as ``deliver`` / ``fail`` / ``audit`` events, and
:func:`repro_torch.obs.events.rebuild_timeseries` replays them into a fresh
store offline.

Non-perturbation contract (same as tracing/audit): recording only READS
finished handles — seeds, plans, reductions and answers are untouched, so
telemetry ON is bit-identical to telemetry OFF, and OFF (the default)
allocates nothing on the query path.
"""

from __future__ import annotations

import math
import threading
from typing import Dict, List, Optional

__all__ = ["Ring", "TemplateSeries", "TemplateTimeSeries", "quantile"]

#: The windowed quantiles every ring exposes in snapshots.
QUANTILES = (0.50, 0.95, 0.99)


def quantile(values: List[float], q: float) -> float:
    """Nearest-rank quantile of ``values`` (0.0 on empty input)."""
    if not values:
        return 0.0
    s = sorted(values)
    idx = min(len(s) - 1, max(0, int(math.ceil(q * len(s))) - 1))
    return float(s[idx])


class Ring:
    """Fixed-capacity float ring buffer with a lifetime push counter."""

    __slots__ = ("cap", "_buf", "_head", "total")

    def __init__(self, cap: int):
        if cap < 1:
            raise ValueError(f"ring capacity must be >= 1, got {cap}")
        self.cap = int(cap)
        self._buf: List[float] = []
        self._head = 0          # next overwrite position once full
        self.total = 0          # lifetime pushes (>= len(self))

    def push(self, v: float) -> None:
        v = float(v)
        if len(self._buf) < self.cap:
            self._buf.append(v)
        else:
            self._buf[self._head] = v
            self._head = (self._head + 1) % self.cap
        self.total += 1

    def __len__(self) -> int:
        return len(self._buf)

    def values(self) -> List[float]:
        """Window contents, oldest first."""
        if len(self._buf) < self.cap:
            return list(self._buf)
        return self._buf[self._head:] + self._buf[:self._head]

    def last(self) -> float:
        if not self._buf:
            return 0.0
        return self._buf[self._head - 1] if len(self._buf) == self.cap \
            else self._buf[-1]

    def stats(self) -> Dict[str, float]:
        """Windowed summary: p50/p95/p99, mean, max, last, window length."""
        vals = self._buf  # order is irrelevant for quantiles
        out = {f"p{int(q * 100)}": quantile(vals, q) for q in QUANTILES}
        out["mean"] = float(sum(vals) / len(vals)) if vals else 0.0
        out["max"] = float(max(vals)) if vals else 0.0
        out["last"] = self.last()
        out["window"] = len(vals)
        out["total"] = self.total
        return out


class TemplateSeries:
    """One template's ring set plus provenance counters (lock owned by the
    parent store — all mutation goes through :class:`TemplateTimeSeries`)."""

    __slots__ = ("key", "sql_example", "latency_s", "pilot_wall_s",
                 "scanned_bytes", "error_ratio", "deliveries", "cached",
                 "shared", "fused", "staged", "fallbacks", "failures",
                 "audited", "audit_violations")

    def __init__(self, key: str, window: int):
        self.key = key
        self.sql_example: Optional[str] = None
        self.latency_s = Ring(window)
        self.pilot_wall_s = Ring(window)
        self.scanned_bytes = Ring(window)
        self.error_ratio = Ring(window)
        self.deliveries = 0
        self.cached = 0
        self.shared = 0
        self.fused = 0
        self.staged = 0
        self.fallbacks = 0
        self.failures = 0
        self.audited = 0
        self.audit_violations = 0

    # -- derived rates (cumulative, not windowed) -----------------------------
    @property
    def fallback_rate(self) -> float:
        return self.fallbacks / self.deliveries if self.deliveries else 0.0

    @property
    def failure_rate(self) -> float:
        return self.failures / self.deliveries if self.deliveries else 0.0

    @property
    def violation_rate(self) -> float:
        return self.audit_violations / self.audited if self.audited else 0.0

    def slo_stats(self) -> Dict[str, float]:
        """The observables SLO targets evaluate against (see obs/slo.py)."""
        return {
            "samples": self.deliveries,
            "p95_latency_s": quantile(self.latency_s.values(), 0.95),
            "fallback_rate": self.fallback_rate,
            "violation_rate": self.violation_rate,
        }

    def snapshot(self) -> Dict[str, object]:
        return {
            "sql": self.sql_example,  # dropped by Prometheus flatten
            "deliveries": self.deliveries,
            "cached": self.cached,
            "shared": self.shared,
            "fused": self.fused,
            "staged": self.staged,
            "fallbacks": self.fallbacks,
            "failures": self.failures,
            "audited": self.audited,
            "audit_violations": self.audit_violations,
            "fallback_rate": self.fallback_rate,
            "failure_rate": self.failure_rate,
            "violation_rate": self.violation_rate,
            "latency_s": self.latency_s.stats(),
            "pilot_wall_s": self.pilot_wall_s.stats(),
            "scanned_bytes": self.scanned_bytes.stats(),
            "error_ratio": self.error_ratio.stats(),
        }


class TemplateTimeSeries:
    """Bounded per-template series store (thread-safe).

    ``max_templates`` bounds residency: past it, the least-recently-updated
    template's rings are evicted (its counters go with it — the store is a
    window over recent behavior, not an archive; lifetime totals live in the
    metrics registry).
    """

    def __init__(self, window: int = 256, max_templates: int = 64):
        if window < 1:
            raise ValueError(f"window must be >= 1, got {window}")
        if max_templates < 1:
            raise ValueError(
                f"max_templates must be >= 1, got {max_templates}")
        self.window = int(window)
        self.max_templates = int(max_templates)
        self._lock = threading.Lock()
        self._series: Dict[str, TemplateSeries] = {}  # insert-ordered (LRU)
        # drain-level streaming latency rings (DrainStats feed)
        self.ttff_s = Ring(window)
        self.ttf_s = Ring(window)
        self.drains = 0

    def _get(self, key: str, sql: Optional[str]) -> TemplateSeries:
        s = self._series.pop(key, None)
        if s is None:
            s = TemplateSeries(key, self.window)
            while len(self._series) >= self.max_templates:
                self._series.pop(next(iter(self._series)))
        self._series[key] = s  # re-insert: most-recently-updated last
        if sql is not None and s.sql_example is None:
            s.sql_example = sql
        return s

    # -- recording ------------------------------------------------------------
    def record_delivery(self, key: str, *, sql: Optional[str] = None,
                        latency_s: float = 0.0, pilot_wall_s: float = 0.0,
                        scanned_bytes: float = 0, cached: bool = False,
                        shared: bool = False, fused: bool = False,
                        staged: bool = False, fallback: bool = False,
                        failed: bool = False) -> None:
        with self._lock:
            s = self._get(key, sql)
            s.deliveries += 1
            s.latency_s.push(latency_s)
            if failed:
                s.failures += 1
                return  # no report: pilot/scan rows would be fabricated
            s.pilot_wall_s.push(pilot_wall_s)
            s.scanned_bytes.push(scanned_bytes)
            s.cached += bool(cached)
            s.shared += bool(shared)
            s.fused += bool(fused)
            s.staged += bool(staged)
            s.fallbacks += bool(fallback)

    def record_audit(self, key: str, ratio: float, passed: bool) -> None:
        with self._lock:
            s = self._get(key, None)
            s.audited += 1
            s.audit_violations += not passed
            s.error_ratio.push(ratio)

    def record_drain(self, ttff_s: Optional[float],
                     ttf_s: Optional[float]) -> None:
        """Streaming latency of one drain() call (None field = no frames /
        no terminal frames among the drain's streaming handles)."""
        with self._lock:
            self.drains += 1
            if ttff_s is not None:
                self.ttff_s.push(ttff_s)
            if ttf_s is not None:
                self.ttf_s.push(ttf_s)

    # -- introspection --------------------------------------------------------
    def series(self, key: str) -> Optional[TemplateSeries]:
        with self._lock:
            return self._series.get(key)

    def keys(self) -> List[str]:
        with self._lock:
            return list(self._series)

    def slo_stats(self, key: str) -> Optional[Dict[str, float]]:
        with self._lock:
            s = self._series.get(key)
            return None if s is None else s.slo_stats()

    def values(self, key: str, field: str = "latency_s") -> List[float]:
        """Raw window contents of one template ring (dashboard sparklines)."""
        with self._lock:
            s = self._series.get(key)
            if s is None:
                return []
            ring = getattr(s, field, None)
            return ring.values() if isinstance(ring, Ring) else []

    def snapshot(self) -> Dict[str, object]:
        """The collector payload: per-template windowed stats plus the
        drain-level streaming rings.  Schema is additive-only (it rides
        ``stats_payload()["timeseries"]``)."""
        with self._lock:
            return {
                "enabled": True,
                "window": self.window,
                "drains": self.drains,
                "ttff_s": self.ttff_s.stats(),
                "ttf_s": self.ttf_s.stats(),
                "templates": {k: s.snapshot()
                              for k, s in self._series.items()},
            }


def empty_snapshot() -> Dict[str, object]:
    """The ``timeseries`` payload section when telemetry is off: the same
    top-level keys, zero state — consumers never key-check."""
    return {"enabled": False, "window": 0, "drains": 0,
            "ttff_s": {}, "ttf_s": {}, "templates": {}}
