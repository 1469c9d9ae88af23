"""Static ops dashboard: one self-contained HTML page from live telemetry.

:func:`render_dashboard` reads a session's observability surfaces — the
metrics registry tree, the per-template time-series, the SLO monitor, the
flight-recorder stats, and the recent sampled traces — and renders them as
a single HTML string with no external assets (inline CSS, inline SVG
sparklines), so the page can be written next to a benchmark run, attached
to a CI artifact, or served from a dumb file endpoint and opened offline.
The reference's ``serve/dashboard.py`` as it is: host code that reads the
port's session, touching no device.

Sections:

* header cards      — session totals (drains, queries, cache hit rates);
* template table    — one row per tracked template: deliveries, provenance
  mix, windowed latency p50/p95/p99, and a latency sparkline drawn from
  the ring's raw window (``TemplateTimeSeries.values``);
* SLO table         — ``SloMonitor.report()`` rows with breached rules
  highlighted;
* recent breaches   — the monitor's bounded recent-breach list;
* sampled traces    — the session's ``recent_traces`` ring (root span,
  duration, child count per trace);
* flight recorder   — emitted/dropped/rotation counters when armed;
* registry text     — the full Prometheus exposition in a ``<pre>``.

Read-only like every obs layer: rendering never mutates session state.
"""

from __future__ import annotations

import html
import json
from typing import List, Optional

__all__ = ["render_dashboard", "write_dashboard"]

_CSS = """
body { font-family: -apple-system, 'Segoe UI', Roboto, sans-serif;
       margin: 1.5rem; color: #1b2733; background: #f7f9fb; }
h1 { font-size: 1.4rem; } h2 { font-size: 1.05rem; margin-top: 1.6rem; }
table { border-collapse: collapse; background: #fff; font-size: 0.82rem; }
th, td { border: 1px solid #d8e0e8; padding: 0.3rem 0.55rem;
         text-align: right; }
th { background: #eef2f6; } td.k, th.k { text-align: left;
     font-family: ui-monospace, monospace; }
.cards { display: flex; flex-wrap: wrap; gap: 0.6rem; }
.card { background: #fff; border: 1px solid #d8e0e8; border-radius: 6px;
        padding: 0.5rem 0.9rem; min-width: 7rem; }
.card .v { font-size: 1.25rem; font-weight: 600; }
.card .l { font-size: 0.72rem; color: #5b6b7b; text-transform: uppercase; }
.breach { background: #fde8e8; } .ok { color: #2c7a3f; }
.bad { color: #b42318; font-weight: 600; }
svg.spark { vertical-align: middle; }
pre { background: #fff; border: 1px solid #d8e0e8; padding: 0.7rem;
      font-size: 0.72rem; overflow-x: auto; }
.muted { color: #5b6b7b; font-size: 0.8rem; }
"""


def _sparkline(values: List[float], width: int = 120, height: int = 24) -> str:
    """Inline SVG polyline over ``values`` (empty string when < 2 points)."""
    if len(values) < 2:
        return ""
    lo, hi = min(values), max(values)
    span = (hi - lo) or 1.0
    n = len(values)
    pts = " ".join(
        f"{i * (width - 2) / (n - 1) + 1:.1f},"
        f"{height - 2 - (v - lo) / span * (height - 4):.1f}"
        for i, v in enumerate(values))
    return (f'<svg class="spark" width="{width}" height="{height}" '
            f'viewBox="0 0 {width} {height}">'
            f'<polyline fill="none" stroke="#3b82c4" stroke-width="1.2" '
            f'points="{pts}"/></svg>')


def _card(label: str, value) -> str:
    return (f'<div class="card"><div class="v">{html.escape(str(value))}'
            f'</div><div class="l">{html.escape(label)}</div></div>')


def _fmt(v, digits: int = 4) -> str:
    if isinstance(v, bool):
        return "yes" if v else "no"
    if isinstance(v, float):
        return f"{v:.{digits}g}"
    return str(v)


def render_dashboard(session, *, title: str = "PilotDB telemetry",
                     max_traces: int = 8) -> str:
    """Render ``session``'s current telemetry as one self-contained HTML
    page.  Works on any session: with telemetry off the template/SLO
    sections state so instead of rendering empty tables."""
    tree = session.metrics.tree()
    ts = getattr(session, "timeseries", None)
    slo = getattr(session, "slo", None)
    recorder = getattr(session, "recorder", None)
    parts: List[str] = [
        "<!doctype html><html><head><meta charset='utf-8'>",
        f"<title>{html.escape(title)}</title>",
        f"<style>{_CSS}</style></head><body>",
        f"<h1>{html.escape(title)}</h1>",
    ]

    # -- header cards ---------------------------------------------------------
    runtime = tree.get("runtime") or {}
    result = tree.get("result_cache") or {}
    compile_ = tree.get("compile_cache") or {}
    snap = ts.snapshot() if ts is not None else None
    cards = [
        _card("queries run", runtime.get("queries_run", 0)),
        _card("pilots run", runtime.get("pilots_run", 0)),
        _card("compile hits", compile_.get("hits", 0)),
        _card("result hits", result.get("hits", 0)),
    ]
    if snap is not None:
        cards += [
            _card("drains", snap["drains"]),
            _card("templates", len(snap["templates"])),
        ]
    if slo is not None:
        s = slo.summary()
        cards.append(_card("SLO breaches", s["breaches_total"]))
    if recorder is not None:
        rstats = recorder.stats()
        cards.append(_card("events logged", rstats["emitted"]))
    parts.append(f'<div class="cards">{"".join(cards)}</div>')

    # -- per-template time-series --------------------------------------------
    parts.append("<h2>Per-template time-series</h2>")
    if snap is None or not snap["templates"]:
        parts.append('<p class="muted">Telemetry is off (or no deliveries '
                     'yet) — enable with SessionConfig(telemetry=True).</p>')
    else:
        parts.append(
            "<table><tr><th class='k'>template</th><th>deliveries</th>"
            "<th>cached</th><th>shared</th><th>fused</th><th>fallbacks</th>"
            "<th>failures</th><th>lat p50 (s)</th><th>lat p95 (s)</th>"
            "<th>lat p99 (s)</th><th>latency window</th>"
            "<th class='k'>sql example</th></tr>")
        for key, t in snap["templates"].items():
            lat = t["latency_s"]
            spark = _sparkline(ts.values(key, "latency_s"))
            sql = t.get("sql") or ""
            if len(sql) > 70:
                sql = sql[:67] + "..."
            parts.append(
                f"<tr><td class='k'>{html.escape(key)}</td>"
                f"<td>{t['deliveries']}</td><td>{t['cached']}</td>"
                f"<td>{t['shared']}</td><td>{t['fused']}</td>"
                f"<td>{t['fallbacks']}</td><td>{t['failures']}</td>"
                f"<td>{_fmt(lat.get('p50', 0.0))}</td>"
                f"<td>{_fmt(lat.get('p95', 0.0))}</td>"
                f"<td>{_fmt(lat.get('p99', 0.0))}</td>"
                f"<td>{spark}</td>"
                f"<td class='k'>{html.escape(sql)}</td></tr>")
        parts.append("</table>")
        ttff = snap["ttff_s"] or {}
        if ttff.get("window"):
            parts.append(
                f'<p class="muted">streaming: time-to-first-frame '
                f'p50={_fmt(ttff.get("p50", 0.0))}s '
                f'p95={_fmt(ttff.get("p95", 0.0))}s over '
                f'{ttff.get("window", 0)} drains</p>')

    # -- SLO ------------------------------------------------------------------
    parts.append("<h2>SLOs</h2>")
    rows = slo.report() if slo is not None else []
    if not rows:
        parts.append('<p class="muted">No SLO targets configured '
                     '(SessionConfig(slo_targets=...) or '
                     'session.slo.set_target(...)).</p>')
    else:
        parts.append(
            "<table><tr><th class='k'>template</th><th class='k'>rule</th>"
            "<th class='k'>metric</th><th>target</th><th>observed</th>"
            "<th>samples</th><th>state</th><th>breaches</th></tr>")
        for r in rows:
            cls = ' class="breach"' if r["breached"] else ""
            state = '<span class="bad">BREACHED</span>' if r["breached"] \
                else '<span class="ok">ok</span>'
            parts.append(
                f"<tr{cls}><td class='k'>{html.escape(r['template'])}</td>"
                f"<td class='k'>{html.escape(r['rule'])}</td>"
                f"<td class='k'>{html.escape(r['metric'])}</td>"
                f"<td>{_fmt(r['target'])}</td><td>{_fmt(r['observed'])}</td>"
                f"<td>{r['samples']}</td><td>{state}</td>"
                f"<td>{r['breaches_total']}</td></tr>")
        parts.append("</table>")
        recent = slo.summary()["recent_breaches"]
        if recent:
            parts.append(f'<p class="muted">{len(recent)} recent breach '
                         f'record(s); latest: '
                         f'{html.escape(json.dumps(recent[-1]))}</p>')

    # -- sampled traces -------------------------------------------------------
    traces = list(getattr(session, "recent_traces", []) or [])
    parts.append("<h2>Sampled traces</h2>")
    if not traces:
        parts.append('<p class="muted">No sampled traces '
                     '(SessionConfig(trace_sample=p) with p &gt; 0).</p>')
    else:
        parts.append("<table><tr><th>query</th><th class='k'>root span</th>"
                     "<th>duration (s)</th><th>spans</th></tr>")
        for tr in traces[-max_traces:]:
            root = tr.get("root") or tr

            def _count(sp):
                return 1 + sum(_count(c) for c in sp.get("children", ()))

            parts.append(
                f"<tr><td>{tr.get('query_id', '?')}</td>"
                f"<td class='k'>{html.escape(str(root.get('name', '?')))}"
                f"</td><td>{_fmt(root.get('duration_s', 0.0))}</td>"
                f"<td>{_count(root)}</td></tr>")
        parts.append("</table>")

    # -- flight recorder ------------------------------------------------------
    if recorder is not None:
        rstats = recorder.stats()
        parts.append(
            f"<h2>Flight recorder</h2><p class='muted'>"
            f"{html.escape(recorder.path)} — {rstats['emitted']} emitted, "
            f"{rstats['dropped']} dropped, {rstats['rotations']} "
            f"rotation(s)</p>")

    # -- raw registry ---------------------------------------------------------
    parts.append("<h2>Metrics registry</h2>")
    parts.append(f"<pre>{html.escape(session.metrics.to_text())}</pre>")
    parts.append("</body></html>")
    return "".join(parts)


def write_dashboard(path: str, session, *,
                    title: str = "PilotDB telemetry",
                    max_traces: int = 8) -> Optional[str]:
    """Render and write the dashboard to ``path``; returns the path, or
    None when the write failed (dashboards are observability — a full disk
    must not fail the caller)."""
    try:
        doc = render_dashboard(session, title=title, max_traces=max_traces)
        with open(path, "w", encoding="utf-8") as fh:
            fh.write(doc)
        return path
    except OSError:
        return None
