"""Observability: tracing, metrics, guarantee audit, continuous telemetry.

Host Python copied from the reference with its imports rewired; nothing
here imports torch or touches the card.  Six pieces, each opt-in and
read-only over the query path:

* :mod:`repro_torch.obs.trace` — per-query span trees (``SessionConfig.tracing``,
  or deterministically sampled via ``trace_sample=p``) exportable as JSON
  or Chrome trace-event format via ``handle.trace()``.
* :mod:`repro_torch.obs.metrics` — counter/gauge/histogram registry + collector
  snapshots (``Session.metrics``); Prometheus text via ``to_text()``.
* :mod:`repro_torch.obs.audit` — EXPLAIN-style reports (``handle.explain()``) and
  opt-in observed-vs-promised error auditing (``SessionConfig.audit``).
* :mod:`repro_torch.obs.timeseries` — per-template bounded ring buffers with
  streaming windowed p50/p95/p99 (``SessionConfig.telemetry``), exposed as
  the registry's ``timeseries`` collector.
* :mod:`repro_torch.obs.slo` — per-template/wildcard latency, fallback-rate and
  guarantee-violation-rate targets evaluated on delivery; breaches surface
  as registry counters and ``Session.slo.report()``.
* :mod:`repro_torch.obs.events` — the flight recorder: append-only size-rotated
  JSONL event log (``SessionConfig.flight_recorder``) with offline replay
  (:func:`repro_torch.obs.events.rebuild_timeseries`).

Span times are host clocks.  On the card a stage's span is honest because
every stage of the port ends in a host read of its outputs; no span adds a
synchronization of its own.

See ``docs/observability.md`` for the span vocabulary, metric names, the
event-record schema, and the non-perturbation contract all six share.
"""

from repro_torch.obs.trace import QueryTrace, span, annotate, annotate_count  # noqa: F401
from repro_torch.obs.metrics import MetricsRegistry, GLOBAL  # noqa: F401
from repro_torch.obs.audit import GuaranteeAuditor, AuditRecord, explain  # noqa: F401
from repro_torch.obs.timeseries import TemplateTimeSeries, Ring  # noqa: F401
from repro_torch.obs.slo import SloMonitor, SloTarget, SloBreach  # noqa: F401
from repro_torch.obs.events import (FlightRecorder, replay,  # noqa: F401
                                    rebuild_timeseries)
