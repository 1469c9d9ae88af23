"""SLO monitor: per-template (or wildcard) serving objectives, evaluated
on delivery.

BlinkDB frames AQP as bounded-error AND bounded-response-time serving;
this module is the response-time half's watchdog.  A :class:`SloTarget`
names a template (the ``trace.sig_hash`` of its constant-stripped group
key, or ``"*"`` for every template) and bounds up to three observables the
per-template time-series already tracks:

* ``p95_latency_s``       — windowed p95 of per-delivery latency,
* ``max_fallback_rate``   — exact-fallback fraction of deliveries,
* ``max_violation_rate``  — audit-mode guarantee-violation fraction
  (observed error > promised ε; requires ``SessionConfig.audit``).

The :class:`SloMonitor` evaluates every matching target after each
delivery (and after each audit record lands).  A breach increments the
``pilotdb_slo_breaches_total`` registry counter, appends a breach record
(surfaced via :meth:`report` / ``gateway.slo_report()``), and emits an
``slo_breach`` flight-recorder event when a recorder is armed.  Like every
obs layer, evaluation only READS — a breached SLO never throttles,
reroutes, or otherwise perturbs query execution.
"""

from __future__ import annotations

import dataclasses
import threading
import time
from collections import deque
from typing import Dict, List, Optional, Tuple

__all__ = ["SloTarget", "SloBreach", "SloMonitor"]


@dataclasses.dataclass(frozen=True)
class SloTarget:
    """One serving objective; ``None`` bounds are not evaluated.

    ``template`` is a 12-hex template key (``trace.sig_hash(group_key)``,
    also the keys of ``stats_payload()["timeseries"]["templates"]``) or
    ``"*"``; ``min_samples`` suppresses evaluation until the template has
    delivered that many queries (quantiles over 1-2 samples are noise).
    """

    template: str = "*"
    p95_latency_s: Optional[float] = None
    max_fallback_rate: Optional[float] = None
    max_violation_rate: Optional[float] = None
    min_samples: int = 1

    # observable name -> (bound field, stats key from TemplateSeries.slo_stats)
    _METRICS = (
        ("p95_latency_s", "p95_latency_s"),
        ("max_fallback_rate", "fallback_rate"),
        ("max_violation_rate", "violation_rate"),
    )


@dataclasses.dataclass
class SloBreach:
    """One breach observation (a target exceeded at one evaluation)."""

    t: float                   # wall-clock epoch seconds
    template: str              # the concrete template key that breached
    rule: str                  # the target's template pattern ("*" or key)
    metric: str                # bound field name on SloTarget
    observed: float
    target: float

    def as_dict(self) -> Dict[str, object]:
        return dataclasses.asdict(self)


class SloMonitor:
    """Evaluates SLO targets against the per-template time-series."""

    def __init__(self, metrics, timeseries, recorder=None,
                 targets: Tuple[SloTarget, ...] = (),
                 max_recent: int = 64) -> None:
        self._timeseries = timeseries
        self._recorder = recorder
        self._lock = threading.Lock()
        self._targets: List[SloTarget] = list(targets)
        self._recent: "deque[SloBreach]" = deque(maxlen=max_recent)
        self._counts: Dict[Tuple[str, str, str], int] = {}  # (rule,key,metric)
        self._evals = metrics.counter(
            "pilotdb_slo_evaluations_total",
            "SLO target evaluations performed on delivery")
        self._breaches = metrics.counter(
            "pilotdb_slo_breaches_total",
            "SLO target evaluations that observed a breach")

    # -- configuration --------------------------------------------------------
    def set_target(self, target: Optional[SloTarget] = None,
                   **kwargs) -> SloTarget:
        """Add a target (``SloTarget(...)`` or keyword form); returns it."""
        if target is None:
            target = SloTarget(**kwargs)
        elif kwargs:
            target = dataclasses.replace(target, **kwargs)
        with self._lock:
            self._targets.append(target)
        return target

    def targets(self) -> List[SloTarget]:
        with self._lock:
            return list(self._targets)

    # -- evaluation (delivery hook; never raises upward through the session) --
    def evaluate(self, key: str) -> List[SloBreach]:
        """Evaluate every target matching template ``key`` against its
        current windowed stats; record and return any breaches."""
        stats = self._timeseries.slo_stats(key) \
            if self._timeseries is not None else None
        if stats is None:
            return []
        breaches: List[SloBreach] = []
        with self._lock:
            targets = [t for t in self._targets
                       if t.template in ("*", key)]
        for t in targets:
            if stats["samples"] < t.min_samples:
                continue
            for field, stat_key in SloTarget._METRICS:
                bound = getattr(t, field)
                if bound is None:
                    continue
                self._evals.inc()
                observed = float(stats[stat_key])
                if observed > bound:
                    breaches.append(SloBreach(
                        t=time.time(), template=key, rule=t.template,
                        metric=field, observed=observed, target=bound))
        for b in breaches:
            self._breaches.inc()
            with self._lock:
                self._recent.append(b)
                ck = (b.rule, b.template, b.metric)
                self._counts[ck] = self._counts.get(ck, 0) + 1
            if self._recorder is not None:
                self._recorder.emit("slo_breach", template=b.template,
                                    rule=b.rule, metric=b.metric,
                                    observed=round(b.observed, 6),
                                    target=b.target)
        return breaches

    # -- reporting ------------------------------------------------------------
    def report(self) -> List[Dict[str, object]]:
        """Current status of every (target, matching template) pair: the
        observed value next to its bound, whether it breaches NOW, and how
        many breach evaluations it has accumulated."""
        out: List[Dict[str, object]] = []
        if self._timeseries is None:
            return out
        keys = self._timeseries.keys()
        with self._lock:
            targets = list(self._targets)
            counts = dict(self._counts)
        for t in targets:
            matched = keys if t.template == "*" else \
                [k for k in keys if k == t.template]
            for key in matched:
                stats = self._timeseries.slo_stats(key)
                if stats is None:
                    continue
                for field, stat_key in SloTarget._METRICS:
                    bound = getattr(t, field)
                    if bound is None:
                        continue
                    observed = float(stats[stat_key])
                    out.append({
                        "template": key,
                        "rule": t.template,
                        "metric": field,
                        "target": bound,
                        "observed": observed,
                        "samples": stats["samples"],
                        "breached": (stats["samples"] >= t.min_samples
                                     and observed > bound),
                        "breaches_total": counts.get(
                            (t.template, key, field), 0),
                    })
        return out

    def summary(self) -> Dict[str, object]:
        """The ``slo`` collector payload (rides ``stats_payload()``)."""
        with self._lock:
            recent = [b.as_dict() for b in self._recent]
            n_targets = len(self._targets)
        return {
            "enabled": True,
            "targets": n_targets,
            "breaches_total": int(self._breaches.value),
            "evaluations_total": int(self._evals.value),
            "recent_breaches": recent,
        }


def empty_summary() -> Dict[str, object]:
    """The ``slo`` payload section when telemetry is off (same keys)."""
    return {"enabled": False, "targets": 0, "breaches_total": 0,
            "evaluations_total": 0, "recent_breaches": []}
