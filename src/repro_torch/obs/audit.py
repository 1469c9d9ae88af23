"""Guarantee auditor: EXPLAIN-style reports and observed-vs-promised error.

Two facilities, both read-only over the query path:

* :func:`explain` — a per-query text report of what the guarantee machinery
  actually did: promised ε / confidence, the solved §3.2 sampling rates,
  the pilot inputs to the §4 bound (n, θ_p), scanned vs full bytes, and
  answer provenance (fresh / shared-pilot / cached / staged / dist /
  exact-fallback).  Available as ``handle.explain()`` once a query is done.

* :class:`GuaranteeAuditor` — opt-in audit mode (``SessionConfig.audit``):
  after each approximate answer is DELIVERED, the auditor runs the exact
  query alongside and records observed vs promised relative error into the
  metrics registry — the runtime version of the paper's Figure-9 check and
  the gate the TPC-H suite will reuse.

Non-perturbation contract.  Audit runs happen *after* ``_mark_done`` (the
client already has its answer), use :meth:`PilotDB.exact` (no RNG, no
sampling seeds), and never write the result cache — and because every seed
in the system is content-derived (session seed × query text × spec), an
extra exact scan cannot shift any other query's sampling.  Audit mode is
therefore bit-identical to non-audit mode on every answer; it only adds
exact scan cost and registry entries.  The auditor compares against the
BASE answer (before HAVING/LIMIT post-filters) so every group the
guarantee covered is checked, and it never raises into the query path.
"""

from __future__ import annotations

import dataclasses
import threading
import time
from typing import Dict, List, Optional

import numpy as np

from repro_torch.obs.trace import GROUP_SPANS

__all__ = ["AuditRecord", "GuaranteeAuditor", "explain", "provenance_of"]


@dataclasses.dataclass
class AuditRecord:
    """Observed-vs-promised outcome for one audited query."""

    query_id: int
    promised_error: float
    confidence: float
    observed_error: float        # max relative error over composites x groups
    error_ratio: float           # observed / promised (<= 1.0 means honored)
    passed: bool
    groups_checked: int
    exact_wall_s: float
    provenance: str
    skipped: Optional[str] = None  # reason the exact run was unnecessary


def provenance_of(handle) -> str:
    """Which path produced the answer: ``cached``, ``exact-fallback``,
    ``shared-pilot``, or ``fresh`` — suffixed ``+staged`` / ``+dist`` /
    ``+fused`` when the trace recorded staged-rung or shard-fanout
    execution, or the single-launch fused program engaged (the
    ``fused`` span with ``engaged=True``; also reported without a trace
    via the handle's fused-delivery flag)."""
    if handle.cached:
        base = "cached"
    else:
        answer = handle._answer
        report = answer.report if answer is not None else None
        if report is not None and report.fallback:
            base = "exact-fallback"
        elif report is not None and report.pilot_shared:
            base = "shared-pilot"
        else:
            base = "fresh"
    tags = []
    trace = getattr(handle, "_trace", None)
    if trace is not None:

        def walk(sp):
            if sp.attrs.get("staged"):
                tags.append("staged")
            if sp.name == "shard_fanout":
                tags.append("dist")
            if sp.name == "fused" and sp.attrs.get("engaged"):
                tags.append("fused")
            for c in sp.children:
                # a drain group's shared work is no one member's provenance
                if c.name not in GROUP_SPANS:
                    walk(c)

        walk(trace.root)
    if not handle.cached and getattr(handle, "_fused", False):
        tags.append("fused")  # untraced fused deliveries still report it
    for tag in ("staged", "dist", "fused"):
        if tag in tags:
            base += f"+{tag}"
    return base


class GuaranteeAuditor:
    """Runs exact queries alongside approximate answers and records the
    observed-vs-promised error ratio into the metrics registry."""

    def __init__(self, db, metrics) -> None:
        self.db = db
        self._lock = threading.Lock()
        self._records: List[AuditRecord] = []
        self._errors = 0
        self._max_ratio = 0.0
        self._runs = metrics.counter(
            "pilotdb_audit_runs_total",
            "Queries audited against an exact run")
        self._violations = metrics.counter(
            "pilotdb_audit_violations_total",
            "Audited queries whose observed error exceeded the promise")
        self._audit_errors = metrics.counter(
            "pilotdb_audit_errors_total",
            "Audit attempts that failed internally (answer unaffected)")
        self._ratio = metrics.histogram(
            "pilotdb_audit_error_ratio",
            "Observed / promised relative error per audited query",
            buckets=(0.01, 0.05, 0.1, 0.25, 0.5, 0.75, 1.0, 2.0, 5.0))
        self._max_gauge = metrics.gauge(
            "pilotdb_audit_max_error_ratio",
            "Largest observed/promised error ratio seen")

    # -- recording ------------------------------------------------------------
    def check(self, handle, base_answer) -> Optional[AuditRecord]:
        """Audit one completed query.  ``base_answer`` is the answer BEFORE
        having/limit post-filters.  Never raises; returns the record (also
        stored on ``handle.audit_record``) or None on internal failure."""
        try:
            return self._check(handle, base_answer)
        except Exception:
            with self._lock:
                self._errors += 1
            self._audit_errors.inc()
            return None

    def _check(self, handle, base_answer) -> AuditRecord:
        spec = handle.spec
        report = base_answer.report
        promised = spec.error if spec is not None else 0.0
        confidence = spec.confidence if spec is not None else 1.0
        prov = provenance_of(handle)

        if spec is None or report.fallback:
            # The delivered answer IS exact (requested exact, or fallback):
            # observed error is zero by construction — no second scan.
            rec = AuditRecord(
                query_id=handle.query_id, promised_error=promised,
                confidence=confidence, observed_error=0.0, error_ratio=0.0,
                passed=True, groups_checked=int(base_answer.group_present.sum()),
                exact_wall_s=0.0, provenance=prov,
                skipped="answer is exact")
        else:
            t0 = time.perf_counter()
            exact = self.db.exact(handle.query)
            wall = time.perf_counter() - t0
            observed, n_checked = _max_rel_error(base_answer, exact)
            ratio = observed / promised if promised > 0 else float("inf")
            rec = AuditRecord(
                query_id=handle.query_id, promised_error=promised,
                confidence=confidence, observed_error=observed,
                error_ratio=ratio, passed=observed <= promised,
                groups_checked=n_checked, exact_wall_s=wall,
                provenance=prov)
            self._ratio.observe(ratio)
            if not rec.passed:
                self._violations.inc()
        self._runs.inc()
        with self._lock:
            self._records.append(rec)
            if rec.error_ratio > self._max_ratio:
                self._max_ratio = rec.error_ratio
                self._max_gauge.set(self._max_ratio)
        handle.audit_record = rec
        return rec

    # -- introspection --------------------------------------------------------
    def records(self) -> List[AuditRecord]:
        with self._lock:
            return list(self._records)

    def summary(self) -> Dict[str, object]:
        with self._lock:
            recs = list(self._records)
            errors = self._errors
            max_ratio = self._max_ratio
        audited = [r for r in recs if r.skipped is None]
        return {
            "runs": len(recs),
            "audited": len(audited),
            "skipped_exact": len(recs) - len(audited),
            "violations": sum(1 for r in audited if not r.passed),
            "errors": errors,
            "max_error_ratio": max_ratio,
            "mean_error_ratio": (
                float(np.mean([r.error_ratio for r in audited]))
                if audited else 0.0),
        }


def _max_rel_error(approx, exact):
    """Max relative error over (composite, present-group) cells where the
    exact value is nonzero — the quantity Eq. 1 bounds by ε."""
    present = np.asarray(approx.group_present, dtype=bool) \
        & np.asarray(exact.group_present, dtype=bool)
    n_checked = int(present.sum())
    if n_checked == 0:
        return 0.0, 0
    a = np.asarray(approx.values)[:, present]
    e = np.asarray(exact.values)[:, present]
    nz = (e != 0) & np.isfinite(e) & np.isfinite(a)
    if not nz.any():
        return 0.0, n_checked
    rel = np.abs(a[nz] - e[nz]) / np.abs(e[nz])
    return float(rel.max()), n_checked


# -- EXPLAIN ------------------------------------------------------------------

def explain(handle) -> str:
    """Per-query text report: the guarantee as promised, solved, and paid
    for.  Requires a finished handle (done or failed)."""
    lines: List[str] = []
    qid = handle.query_id
    lines.append(f"Query {qid}: {handle.sql or '<programmatic>'}")
    if handle.status == "failed":
        lines.append(f"  status: FAILED — {handle.error}")
        return "\n".join(lines)
    if not handle.done:
        lines.append(f"  status: {handle.status} (in flight)")
        return "\n".join(lines)

    answer = handle._answer
    report = answer.report
    spec = handle.spec
    lines.append(f"  provenance: {provenance_of(handle)}")
    trace = getattr(handle, "_trace", None)
    fused_spans = trace.find("fused") if trace is not None else []
    if fused_spans:
        sp = fused_spans[0]
        lines.append(
            "  fused: engaged (single launch, 0 host syncs)"
            if sp.attrs.get("engaged")
            else "  fused: attempted, fell back to the two-stage path")
    if spec is None:
        lines.append("  guarantee: none (exact execution requested)")
    else:
        lines.append(
            f"  guarantee: ERROR {spec.error * 100:g}% "
            f"CONFIDENCE {spec.confidence * 100:g}% (a priori, Eq. 1)")
    if report.fallback:
        lines.append(f"  fallback: exact — {report.fallback}")
    if report.pilot_ran or report.pilot_shared:
        shared = " (shared)" if report.pilot_shared else ""
        lines.append(
            f"  pilot{shared}: table={report.pilot_table} "
            f"theta_p={report.theta_pilot:g} "
            f"n_blocks={report.n_pilot_blocks} "
            f"scanned={report.pilot_scanned_bytes:,}B "
            f"wall={report.pilot_time_s * 1e3:.2f}ms")
    if report.plan is not None and not report.fallback:
        rates = ", ".join(
            f"{t}={r:.6f}" for t, r in sorted(report.plan.rates.items()))
        lines.append(
            f"  solved rates (§3.2, {report.candidates} candidates): {rates}")
        lines.append(
            f"  final: scanned={report.final_scanned_bytes:,}B "
            f"vs exact~{report.exact_scanned_bytes:,}B "
            f"wall={report.final_time_s * 1e3:.2f}ms")
    if not report.group_coverage_guaranteed:
        lines.append(
            "  WARNING: group coverage not formally guaranteed "
            "(pilot rate capped below Lemma 3.2)")
    n_groups = int(np.asarray(answer.group_present).sum())
    lines.append(
        f"  answer: {len(answer.names)} aggregate(s) x {n_groups} group(s)"
        + (" [cached]" if handle.cached else ""))
    rec = getattr(handle, "audit_record", None)
    if rec is not None:
        if rec.skipped:
            lines.append(f"  audit: skipped — {rec.skipped}")
        else:
            verdict = "OK" if rec.passed else "VIOLATED"
            lines.append(
                f"  audit: observed={rec.observed_error:.5f} "
                f"promised={rec.promised_error:g} "
                f"ratio={rec.error_ratio:.3f} [{verdict}] "
                f"(exact wall={rec.exact_wall_s * 1e3:.1f}ms)")
    return "\n".join(lines)
