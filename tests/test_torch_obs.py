"""Observability (``repro_torch.obs``) against the reference and against
itself, on the CPU: tracing, the metrics registry, the guarantee auditor
and continuous telemetry (time-series, SLOs, the flight recorder, sampled
tracing).

The reference's ``tests/test_obs.py`` cases run here by name against the
port, on the reference tests' own catalog, ``tpch_catalog(scale_rows=200_000,
block_rows=32, seed=0)``, built by both packages from the same numpy seed
(the port's with ``device="cpu"``).  The contracts are the reference's:
tracing, audit and telemetry OFF (the default) carry no trace object, no
completion hook and no recorder; ON, every answer is bitwise the hooks-off
answer of an equal-seed session — solo, herd, batched finals, cached,
staged, sharded, fused — and every completed, fallback or failed query ends
with a closed span tree.

Where a case compares two runs, the port is also held to the reference:
the span-name trees (names and nesting only, the port's own spans taken
out) equal; the flight recorder's event-type sequence for one herd equal;
the Prometheus metric names equal.  Span attributes are not compared:
``compile_sig`` hashes the port's compile keys, which hold torch devices and
dtypes.  The port's own spans (the host draw, the dispatch, compilations
and host reads under each scan, the advisory estimate, the rate solve's
parts, a drain group's shared work) and ``TaqaReport.ppf_calls`` are held
to their own contracts below.

Left out until the port's serving gateway lands (ROADMAP queue 1 item 10
(c)): ``test_gateway_metrics_text_includes_gateway_counters``,
``test_timeseries_rides_registry_and_stats_payload``,
``test_dashboard_renders_self_contained_html`` and the gateway half of
``test_slo_breach_round_trip`` (its session half runs here).
"""

import functools
import json
import os

import numpy as np
import pytest

import repro.api as ref_api
from repro.engine.datagen import tpch_catalog as ref_tpch_catalog
from repro.obs.events import replay as ref_replay
from repro_torch.api import ErrorFrame, SessionConfig
from repro_torch.api import Session as _Session
from repro_torch.core.taqa import PilotDB
from repro_torch.engine.datagen import tpch_catalog
from repro_torch.obs import GLOBAL, MetricsRegistry, QueryTrace
from repro_torch.obs import trace as trace_mod
from repro_torch.obs.audit import provenance_of
from repro_torch.obs.events import rebuild_timeseries, replay
from repro_torch.obs.slo import SloTarget
from repro_torch.obs.timeseries import Ring, TemplateTimeSeries, quantile

Session = functools.partial(_Session, device="cpu")

HERD_SQL = ("SELECT SUM(l_extendedprice * l_discount) AS rev FROM lineitem "
            "WHERE l_quantity < 24 ERROR 8% CONFIDENCE 95%")
GROUPED_SQL = ("SELECT SUM(l_quantity) AS q, COUNT(*) AS n FROM lineitem "
               "WHERE l_quantity < 30 GROUP BY l_returnflag MAXGROUPS 3 "
               "ERROR 10% CONFIDENCE 90%")
TEMPLATE_SQL = ("SELECT SUM(l_extendedprice) AS rev FROM lineitem "
                "WHERE l_quantity < {} ERROR 10% CONFIDENCE 90%")

SERIAL = dict(async_workers=0, share_pilots=False, result_cache_size=0)
NOCACHE = dict(async_workers=4, result_cache_size=0)
SERIAL_CFG = SessionConfig(**SERIAL)
NOCACHE_CFG = SessionConfig(**NOCACHE)
TRACE_SERIAL = SessionConfig(**SERIAL, tracing=True)
TRACE_HERD = SessionConfig(**NOCACHE, tracing=True)


@pytest.fixture(scope="module")
def catalogs():
    return (ref_tpch_catalog(scale_rows=200_000, block_rows=32, seed=0),
            tpch_catalog(scale_rows=200_000, block_rows=32, seed=0,
                         device="cpu"))


@pytest.fixture(scope="module")
def catalog(catalogs):
    return catalogs[1]


def _assert_bitwise(a, b):
    assert np.array_equal(a.values, b.values)
    assert np.array_equal(a.group_present, b.group_present)
    assert list(a.names) == list(b.names)


# the spans the port adds to the reference's vocabulary
# (docs/torch_observability.md)
PORT_SPANS = {"draw", "dispatch", "compile", "host_read", "advisory",
              "bounds", "solve", "pick", "group_pilots", "group_finals"}


def _tree(trace):
    """A span tree as names and nesting only, without the port's own spans:
    each gives its place to its children, but for ``group_pilots``, which
    goes whole, since the group's stage-1 scans under it belong to no
    member's tree in the reference."""
    def kids(sp):
        out = []
        for c in sp.children:
            if c.name == "group_pilots":
                continue
            if c.name in PORT_SPANS:
                out.extend(kids(c))
            else:
                out.append((c.name, kids(c)))
        return out
    return (trace.root.name, kids(trace.root))


def _ref_session(ref_cat, seed, **cfg):
    return ref_api.Session(ref_cat, seed=seed,
                           config=ref_api.SessionConfig(**cfg))


# ---------------------------------------------------------------------------
# Zero-overhead default: tracing OFF is the untraced path
# ---------------------------------------------------------------------------

def test_tracing_off_by_default(catalog):
    s = Session(catalog, seed=3, config=SERIAL_CFG)
    h = s.sql(HERD_SQL)
    assert h._trace is None and h._on_complete is None
    assert h.trace() is None and h.trace("chrome") is None
    assert trace_mod.active() is None
    # instrumentation points degrade to the shared no-op span
    assert trace_mod.span("anything") is trace_mod.NULL_SPAN
    assert s.recorder is None and s.timeseries is None and s.auditor is None


def test_trace_format_validated(catalog):
    s = Session(catalog, seed=3, config=TRACE_SERIAL)
    h = s.sql(HERD_SQL)
    with pytest.raises(ValueError):
        h.trace(fmt="protobuf")


# ---------------------------------------------------------------------------
# Bit-identity: tracing observes, never steers; trees match the reference
# ---------------------------------------------------------------------------

def test_traced_solo_bitwise_identical(catalogs):
    ref_cat, catalog = catalogs
    plain = Session(catalog, seed=3, config=SERIAL_CFG).sql(HERD_SQL)
    traced = Session(catalog, seed=3, config=TRACE_SERIAL).sql(HERD_SQL)
    assert traced.fallback is None
    _assert_bitwise(traced.answer, plain.answer)
    ref = _ref_session(ref_cat, 3, **SERIAL, tracing=True).sql(HERD_SQL)
    assert _tree(traced._trace) == _tree(ref._trace)


def test_traced_herd_bitwise_identical(catalogs):
    ref_cat, catalog = catalogs
    solo = Session(catalog, seed=11, config=SERIAL_CFG).sql(HERD_SQL)
    rt = Session(catalog, seed=11, config=TRACE_HERD)
    handles = [rt.submit(HERD_SQL) for _ in range(5)]
    p0 = rt.executor.pilots_run
    rt.drain()
    assert rt.executor.pilots_run - p0 == 1  # tracing kept pilot sharing
    for h in handles:
        _assert_bitwise(h.answer, solo.answer)
        assert h._trace is not None and h._trace.open_spans() == []
    rt.close()
    ref = _ref_session(ref_cat, 11, **NOCACHE, tracing=True)
    ref_handles = [ref.submit(HERD_SQL) for _ in range(5)]
    ref.drain()
    assert [_tree(h._trace) for h in handles] == \
        [_tree(h._trace) for h in ref_handles]
    ref.close()


def test_traced_batched_finals_bitwise(catalogs):
    ref_cat, catalog = catalogs
    cuts = [18, 24, 30, 36]
    serial = Session(catalog, seed=9, config=SERIAL_CFG)
    want = {c: serial.sql(TEMPLATE_SQL.format(c)).answer for c in cuts}
    rt = Session(catalog, seed=9, config=TRACE_HERD)
    handles = {c: rt.submit(TEMPLATE_SQL.format(c)) for c in cuts}
    rt.drain()
    for c, h in handles.items():
        _assert_bitwise(h.answer, want[c])
        assert h._trace.open_spans() == []
    rt.close()
    ref = _ref_session(ref_cat, 9, **NOCACHE, tracing=True)
    ref_handles = {c: ref.submit(TEMPLATE_SQL.format(c)) for c in cuts}
    ref.drain()
    for c in cuts:
        assert _tree(handles[c]._trace) == _tree(ref_handles[c]._trace)
    ref.close()


def test_traced_cached_reissue_bitwise_and_provenance(catalogs):
    ref_cat, catalog = catalogs
    s = Session(catalog, seed=13, config=SessionConfig(tracing=True))
    first = s.sql(HERD_SQL)
    again = s.sql(HERD_SQL)
    assert again.cached
    _assert_bitwise(again.answer, first.answer)
    assert again._trace.open_spans() == []
    hits = [sp for sp in again._trace.find("cache_lookup")
            if sp.attrs.get("hit")]
    assert hits
    assert provenance_of(again) == "cached"
    s.close()
    rs = _ref_session(ref_cat, 13, tracing=True)
    r_first, r_again = rs.sql(HERD_SQL), rs.sql(HERD_SQL)
    assert _tree(first._trace) == _tree(r_first._trace)
    assert _tree(again._trace) == _tree(r_again._trace)
    rs.close()


@pytest.mark.parametrize("shards", [1, 2])
def test_traced_sharded_bitwise_with_fanout_span(catalogs, shards):
    ref_cat, catalog = catalogs
    mono = Session(catalog, seed=31, config=SERIAL_CFG).sql(GROUPED_SQL)
    s = Session(seed=31, config=TRACE_SERIAL)
    for name, tab in catalog.items():
        s.register_table(name, tab,
                         shards=shards if name == "lineitem" else None)
    h = s.sql(GROUPED_SQL)
    _assert_bitwise(h.answer, mono.answer)
    fanouts = h._trace.find("shard_fanout")
    if mono.fallback is None:
        assert fanouts and fanouts[0].attrs["shards"] == shards
        assert "+dist" in provenance_of(h)
    rs = ref_api.Session(seed=31, config=ref_api.SessionConfig(
        **SERIAL, tracing=True))
    for name, tab in ref_cat.items():
        rs.register_table(name, tab,
                          shards=shards if name == "lineitem" else None)
    assert _tree(h._trace) == _tree(rs.sql(GROUPED_SQL)._trace)


def test_traced_staged_bitwise_with_staged_tags(catalogs):
    ref_cat, catalog = catalogs

    def _run(make, cat, rates, cfg):
        s = make(seed=41, config=cfg)
        for name, tab in cat.items():
            s.register_table(name, tab,
                             staged_rates=rates if name == "lineitem"
                             else None)
        return s, s.sql(HERD_SQL)

    _, ref = _run(Session, catalog, [1e-9], SERIAL_CFG)  # never serves
    s, hot = _run(Session, catalog, True, TRACE_SERIAL)  # default, traced
    assert s.executor.staged_info()["hits"] > 0
    _assert_bitwise(hot.answer, ref.answer)
    tagged = [sp for sp in hot._trace.find("scan") if sp.attrs.get("staged")]
    assert tagged
    assert "+staged" in provenance_of(hot)
    _, r_hot = _run(ref_api.Session, ref_cat, True,
                    ref_api.SessionConfig(**SERIAL, tracing=True))
    assert _tree(hot._trace) == _tree(r_hot._trace)
    assert [sp.attrs.get("staged") for sp in hot._trace.find("scan")] == \
        [sp.attrs.get("staged") for sp in r_hot._trace.find("scan")]


# ---------------------------------------------------------------------------
# Span tree: vocabulary, closure, export
# ---------------------------------------------------------------------------

def test_solo_span_vocabulary_and_attrs(catalog):
    s = Session(catalog, seed=3, config=TRACE_SERIAL)
    h = s.sql(HERD_SQL)
    tr = h._trace
    assert tr.status == "ok" and tr.open_spans() == []
    names = set(tr.span_names())
    assert {"query", "parse", "lower", "pilot", "rate_solve",
            "final", "deliver"} <= names
    pilot, = tr.find("pilot")
    assert pilot.attrs["table"] == "lineitem"
    assert pilot.attrs["scanned_bytes"] > 0
    assert pilot.attrs["shared"] is False
    final, = tr.find("final")
    assert final.attrs["scanned_bytes"] > 0
    lower, = tr.find("lower")
    assert lower.attrs["seed"] == h.seed
    # nested engine scans attach under their stages; each scan's dispatch
    # is tagged with the physical layer's compile hits / misses
    assert any(c.name == "scan" for c in pilot.children)
    scan = [c for c in pilot.children if c.name == "scan"][0]
    dispatch, = [c for c in scan.children if c.name == "dispatch"]
    assert dispatch.attrs.get("compile_hits", 0) \
        + dispatch.attrs.get("compile_misses", 0) >= 1
    assert isinstance(dispatch.attrs["compile_sig"], str)


# ---------------------------------------------------------------------------
# The port's own spans and counter (no counterpart in the reference)
# ---------------------------------------------------------------------------

def _kids(sp, name):
    return [c for c in sp.children if c.name == name]


def _within(child, parent):
    return parent.t0 <= child.t0 <= child.t1 <= parent.t1


def test_solo_stages_draw_dispatch_advisory_and_rate_solve_parts(catalog):
    s = Session(catalog, seed=3, config=TRACE_SERIAL)
    h = s.sql(HERD_SQL)
    tr = h._trace
    assert h.fallback is None
    # every sampled scan (the pilot's, the final's) draws its blocks on the
    # host, then dispatches its compiled callable, then reads its sums
    scans = tr.find("scan")
    assert len(scans) >= 2
    for scan in scans:
        draw, = _kids(scan, "draw")
        dispatch, = _kids(scan, "dispatch")
        assert draw.attrs["n_blocks"] == catalog["lineitem"].num_blocks
        assert 0.0 < draw.attrs["rate"] < 1.0 and draw.attrs["n_drawn"] > 0
        assert draw.t1 <= dispatch.t0
        reads = _kids(scan, "host_read") + _kids(dispatch, "host_read")
        assert reads and all(r.attrs["bytes"] > 0 for r in reads)
        assert all(_within(c, scan) for c in scan.children)
    # the advisory estimate runs after the pilot and before the rate solve,
    # whose three parts run in order inside it
    top = [c.name for c in tr.root.children]
    assert top.index("pilot") < top.index("advisory") < top.index("rate_solve")
    pilot, = tr.find("pilot")
    advisory, = tr.find("advisory")
    rate_solve, = tr.find("rate_solve")
    assert pilot.t1 <= advisory.t0 and advisory.t1 <= rate_solve.t0
    parts = rate_solve.children
    assert [c.name for c in parts] == ["bounds", "solve", "pick"]
    assert all(_within(c, rate_solve) for c in parts)
    assert all(a.t1 <= b.t0 for a, b in zip(parts, parts[1:]))
    # the tree's zero on the span clock, for placing it on a device trace
    assert h.trace()["t0_perf_s"] == tr.t0 == h.t_submit


def test_compile_span_on_a_cache_miss_only(catalog):
    s = Session(catalog, seed=3, config=TRACE_SERIAL)
    first, again = s.sql(HERD_SQL), s.sql(HERD_SQL)  # no result cache
    for h in (first, again):
        for d in h._trace.find("dispatch"):
            assert len(_kids(d, "compile")) == d.attrs.get("compile_misses", 0)
            assert d.attrs.get("compile_misses", 0) \
                + d.attrs.get("compile_hits", 0) == 1
    assert first._trace.find("compile")
    assert not again._trace.find("compile")
    assert all(d.attrs["compile_hits"] == 1
               for d in again._trace.find("dispatch"))


def _drain_shapes(shape):
    """(session config, queries, drained?) of a shape of the query path."""
    cuts = [TEMPLATE_SQL.format(c) for c in (18, 24, 30, 36, 40)]
    return {
        "solo": (dict(SERIAL), [HERD_SQL, GROUPED_SQL], False),
        "exact": (dict(SERIAL), ["SELECT SUM(l_quantity) AS q FROM lineitem"],
                  False),
        "fused": (dict(SERIAL, fused_taqa=True), [HERD_SQL], False),
        "staged": (dict(SERIAL), [HERD_SQL, HERD_SQL], False),
        "drain": (dict(NOCACHE), cuts + [HERD_SQL] * 3, True),
    }[shape]


@pytest.mark.parametrize("shape", ["solo", "exact", "fused", "staged", "drain"])
def test_host_read_spans_count_the_helper_calls(catalog, monkeypatch, shape):
    """One ``host_read`` span a call of the one helper every wait of the
    host on the device goes through, on every path: a drain group's shared
    work lands on its first member's tree, after that member's delivery
    too."""
    from repro_torch.engine import syncs
    real, calls = syncs.host_read, []

    def counted(*arrays):
        calls.append(sum(int(a.nbytes) for a in arrays if a is not None))
        return real(*arrays)

    cfg, sqls, drained = _drain_shapes(shape)
    s = Session(seed=3, config=SessionConfig(**cfg, tracing=True))
    for name, tab in catalog.items():
        s.register_table(name, tab, staged_rates=(
            True if shape == "staged" and name == "lineitem" else None))
    monkeypatch.setattr(syncs, "host_read", counted)
    if drained:
        handles = [s.submit(q) for q in sqls]
        s.drain()
    else:
        handles = [s.sql(q) for q in sqls]
    s.close()
    assert all(h.status == "done" for h in handles)
    assert (s.executor.staged_info()["hits"] > 0) == (shape == "staged")
    reads = [sp for h in handles for sp in h._trace.find("host_read")]
    assert calls and len(reads) == len(calls)
    assert sorted(sp.attrs["bytes"] for sp in reads) == sorted(calls)
    assert all(h._trace.open_spans() == [] for h in handles)


def test_drain_group_spans_on_every_member(catalog):
    """Two or more pilot subgroups: the stacked pilots and the batched
    finals are one span each on every member, with the same start and the
    lanes of their stacked launches, after every member's wait in the
    queue; the first member's holds the work's draws, dispatches and
    reads."""
    cuts = (18, 24, 30, 36)
    s = Session(catalog, seed=9, config=TRACE_HERD)
    handles = [s.submit(TEMPLATE_SQL.format(c)) for c in cuts]
    s.drain()
    s.close()
    for name in trace_mod.GROUP_SPANS:
        spans = [h._trace.find(name) for h in handles]
        assert all(len(sp) == 1 for sp in spans), name
        spans = [sp for sp, in spans]
        assert len({sp.t0 for sp in spans}) == 1
        assert len({sp.t1 for sp in spans}) == 1
        for h, sp in zip(handles, spans):
            assert sp.attrs["members"] == len(cuts)
            lanes = sp.attrs["lanes"]
            assert sum([lanes] if isinstance(lanes, int) else lanes) <= len(cuts)
            sched, = h._trace.find("schedule")
            assert sched.t1 <= sp.t0
            assert sp in h._trace.root.children
    lead = handles[0]._trace
    pilots, = lead.find("group_pilots")
    assert pilots.attrs["lanes"] == len(cuts)  # one stacked launch
    assert {c.name for c in pilots.children} >= {"draw", "scan"}
    finals, = lead.find("group_finals")
    assert {"draw", "dispatch", "host_read"} <= {c.name for c in finals.children}
    for h in handles[1:]:
        for name in trace_mod.GROUP_SPANS:
            sp, = h._trace.find(name)
            assert sp.children == []
    # a member's telemetry reads its own scans, not the group's
    assert handles[0]._trace.find("scan", skip=trace_mod.GROUP_SPANS) == []


def test_ppf_calls_count_each_rate_solve(catalog):
    """``TaqaReport.ppf_calls``: the rate solve's percentile evaluations,
    counted on its own thread, so a threaded drain counts what a serial
    one does; 0 where no rate solve ran."""
    sqls = [TEMPLATE_SQL.format(c) for c in (18, 24, 30)] + [GROUPED_SQL]
    serial = Session(catalog, seed=9, config=SERIAL_CFG)
    want = [serial.sql(q).report.ppf_calls for q in sqls]
    assert all(n > 0 for n in want)
    assert serial.sql("SELECT SUM(l_quantity) AS q FROM lineitem"
                      ).report.ppf_calls == 0
    for cfg in (NOCACHE_CFG, SessionConfig(**NOCACHE, tracing=True)):
        s = Session(catalog, seed=9, config=cfg)
        handles = [s.submit(q) for q in sqls]
        s.drain()
        s.close()
        assert [h.report.ppf_calls for h in handles] == want


def test_group_span_mechanics():
    """A held group span outlives its member's delivery; with no member
    traced it does nothing; lanes noted outside one go nowhere."""
    lead, other = QueryTrace(0), QueryTrace(1)
    trace_mod.note_lanes(3)  # no group open: a no-op
    with trace_mod.group_span("group_finals", [lead, None, other]):
        assert trace_mod.active() is lead
        trace_mod.note_lanes(2)
        with trace_mod.span("dispatch"):
            pass
        lead.finish("ok")   # delivered inside the group's work
        other.finish("ok")
        with trace_mod.span("host_read"):  # still lands on the lead
            pass
        trace_mod.note_lanes(1)
    assert trace_mod.active() is None
    sp, = lead.find("group_finals")
    copy, = other.find("group_finals")
    assert (sp.t0, sp.t1) == (copy.t0, copy.t1) and sp.t1 >= lead.root.t1
    assert sp.attrs == copy.attrs == {"members": 3, "lanes": [2, 1]}
    assert [c.name for c in sp.children] == ["dispatch", "host_read"]
    assert lead.open_spans() == [] and other.open_spans() == []
    with trace_mod.group_span("group_pilots", [None, None]):
        assert trace_mod.active() is None
    with pytest.raises(RuntimeError):
        tr = QueryTrace(2)
        with trace_mod.group_span("group_pilots", [tr]):
            raise RuntimeError("stacked launch failed")
    sp, = tr.find("group_pilots")
    assert sp.status == "error" and "stacked launch failed" in sp.attrs["error"]


def test_traced_threads_stress_no_misattributed_spans(catalog):
    """More group workers than cores and a short switch interval: every
    handle's tree holds its own spans only (context variables do not follow
    work into a pool, so each member's trace is activated explicitly), and
    every answer is bitwise the untraced serial session's."""
    import sys
    cols = ("l_quantity", "l_extendedprice", "l_discount", "l_tax")
    wheres = ("l_quantity < 30", "l_shipdate < 2000", "l_discount > 0.02")
    sqls = [f"SELECT SUM({c}) AS v FROM lineitem WHERE {w} "
            f"ERROR {e}% CONFIDENCE 95%"
            for c in cols for w in wheres for e in (8, 9)]
    serial = Session(catalog, seed=29, config=SERIAL_CFG)
    want = [serial.sql(q).answer for q in sqls]
    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-5)
    try:
        s = Session(catalog, seed=29, config=SessionConfig(
            async_workers=3 * (os.cpu_count() or 1), result_cache_size=0,
            tracing=True))
        handles = [s.submit(q) for q in sqls]
        s.drain()
        s.close()
    finally:
        sys.setswitchinterval(old)
    assert s.scheduler.last_drain.n_groups == len(cols) * len(wheres)
    assert s.runtime.in_flight == 0
    for h, a in zip(handles, want):
        assert h.status == "done", h.error
        _assert_bitwise(h.answer, a)
        tr = h._trace
        assert tr.root.attrs["query_id"] == h.query_id
        assert tr.open_spans() == []
        lower, = tr.find("lower")
        assert lower.attrs["seed"] == h.seed
        names = tr.span_names()
        for name in ("lower", "parse", "schedule", "pilot", "rate_solve",
                     "final", "deliver"):
            assert names.count(name) == 1, (name, names)


def test_scheduled_drain_closes_schedule_span(catalog):
    s = Session(catalog, seed=3, config=TRACE_HERD)
    h = s.submit(HERD_SQL)
    assert "schedule" in h._trace.open_spans()
    s.drain()
    assert h._trace.open_spans() == []
    sched, = h._trace.find("schedule")
    assert sched.t1 is not None
    s.close()


def test_trace_exports_json_and_chrome(catalog):
    s = Session(catalog, seed=3, config=TRACE_SERIAL)
    h = s.sql(HERD_SQL)
    tree = h.trace()
    json.dumps(tree)  # JSON-able throughout
    assert tree["status"] == "ok" and tree["root"]["name"] == "query"
    assert tree["root"]["attrs"]["sql"] == HERD_SQL
    events = h.trace("chrome")
    json.dumps(events)
    assert all(e["ph"] == "X" and e["pid"] == h.query_id for e in events)
    assert {e["name"] for e in events} >= {"query", "pilot", "final"}
    assert all(e["ts"] >= 0 and e["dur"] >= 0 for e in events)


def test_failed_query_trace_closed_with_error_status(catalogs):
    ref_cat, catalog = catalogs
    bad = "SELECT COUNT(*) AS n FROM not_a_table GROUP BY g"
    s = Session(catalog, seed=3, config=TRACE_HERD)
    h = s.submit(bad)
    s.drain()
    assert h.status == "failed"
    assert h._trace.status == "error" and h._trace.open_spans() == []
    assert h.trace()["root"]["attrs"]["error"] == h.error
    s.close()
    rs = _ref_session(ref_cat, 3, **NOCACHE, tracing=True)
    r = rs.submit(bad)
    rs.drain()
    assert _tree(h._trace) == _tree(r._trace)
    rs.close()


def _flaky_prepare(monkeypatch, cls):
    real = cls.prepare_final

    def flaky(self, q, spec, outcome, seed, shared=False):
        if abs(spec.error - 0.07) < 1e-12:
            raise RuntimeError("worker exploded mid-group")
        return real(self, q, spec, outcome, seed, shared=shared)

    monkeypatch.setattr(cls, "prepare_final", flaky)


MID_GROUP = [("SELECT SUM(l_extendedprice) AS rev FROM lineitem "
              f"WHERE l_shipdate < 2000 ERROR {e}% CONFIDENCE 95%")
             for e in (8, 7, 6)]


def test_mid_group_failure_traced_closes_spans_and_error_frame(
        catalog, monkeypatch):
    session = Session(catalog, seed=5, config=TRACE_HERD)
    _flaky_prepare(monkeypatch, PilotDB)
    handles = [session.submit(s, stream=True) for s in MID_GROUP]
    session.drain()
    assert [h.status for h in handles] == ["done", "failed", "done"]
    for h in handles:
        assert h._trace.open_spans() == []  # every tree closed
        frames = list(h.stream())           # terminates, never hangs
        assert frames[-1].terminal
    failed = handles[1]
    assert failed._trace.status == "error"
    assert isinstance(failed.frames()[-1], ErrorFrame)
    assert {"pilot", "final"} <= set(handles[0]._trace.span_names())
    session.close()


def test_trace_mechanics_null_span_after_finish():
    tr = QueryTrace(0)
    with tr.span("a", k=1) as sp:
        assert tr.open_spans() == ["query", "a"]
        sp.set(extra=2)
    assert tr.open_spans() == ["query"]
    tr.finish("ok")
    assert tr.finished and tr.open_spans() == []
    assert tr.span("late") is trace_mod.NULL_SPAN
    before = tr.span_names()
    tr.record("late2")
    tr.finish("error")  # idempotent: first status wins
    assert tr.span_names() == before and tr.status == "ok"


def test_trace_span_error_status_on_exception():
    tr = QueryTrace(1)
    with pytest.raises(RuntimeError):
        with tr.span("boom"):
            raise RuntimeError("bad")
    sp, = tr.find("boom")
    assert sp.status == "error" and "RuntimeError: bad" in sp.attrs["error"]
    assert not sp.open


# ---------------------------------------------------------------------------
# Metrics registry
# ---------------------------------------------------------------------------

def test_registry_instruments_get_or_create_and_kinds():
    reg = MetricsRegistry()
    c = reg.counter("x_total", "help text")
    c.inc()
    c.inc(2)
    assert reg.counter("x_total").value == 3
    g = reg.gauge("x_now")
    g.set(1.5)
    assert g.value == 1.5
    hist = reg.histogram("x_seconds")
    hist.observe(0.003)
    hist.observe(0.3)
    assert hist.count == 2 and hist.max == 0.3
    with pytest.raises(TypeError):
        reg.gauge("x_total")


def test_registry_prometheus_text_format():
    reg = MetricsRegistry()
    reg.counter("req_total", "requests").inc(4)
    reg.histogram("lat_seconds", buckets=(0.1, 1.0)).observe(0.5)
    reg.register_collector("cache", lambda: {"hits": 2, "nested": {"n": 1},
                                             "name": "dropme"})
    text = reg.to_text()
    assert "# TYPE req_total counter" in text
    assert "req_total 4" in text
    assert '# HELP req_total requests' in text
    assert 'lat_seconds_bucket{le="0.1"} 0' in text
    assert 'lat_seconds_bucket{le="1"} 1' in text
    assert 'lat_seconds_bucket{le="+Inf"} 1' in text
    assert "lat_seconds_count 1" in text
    assert "cache_hits 2" in text and "cache_nested_n 1" in text
    assert "dropme" not in text
    assert text.endswith("\n")


def test_registry_collector_dies_with_owner():
    reg = MetricsRegistry()

    class Owner:
        pass

    o = Owner()
    reg.register_collector("mine", lambda: {"v": 1}, owner=o)
    assert reg.tree() == {"mine": {"v": 1}}
    del o
    assert reg.tree() == {}


def _metric_names(text):
    return {line.split()[0].split("{")[0] for line in text.splitlines()
            if line and not line.startswith("#")}


def test_session_collectors_match_sources(catalogs):
    ref_cat, catalog = catalogs
    s = Session(catalog, seed=5)
    s.sql(HERD_SQL)
    tree = s.metrics.tree()
    info = s.compile_cache_info()
    assert tree["compile_cache"]["hits"] == info.hits
    assert tree["compile_cache"]["misses"] == info.misses
    assert tree["compile_cache"]["pilot_misses"] == info.pilot_misses >= 1
    rc = s.result_cache_info()
    assert tree["result_cache"]["hits"] == rc.hits
    assert tree["result_cache"]["bytes_used"] == rc.bytes_used
    assert tree["staged"]["tables"] == {}
    assert tree["runtime"]["queries_run"] == s.executor.queries_run
    assert tree["runtime"]["pilots_run"] == s.executor.pilots_run
    assert tree["audit"] == {"runs": 0, "violations": 0, "errors": 0,
                             "max_error_ratio": 0.0}
    # the same Prometheus metric names as the reference's session
    rs = ref_api.Session(ref_cat, seed=5)
    rs.sql(HERD_SQL)
    assert _metric_names(s.metrics.to_text()) == \
        _metric_names(rs.metrics.to_text())
    s.close()
    rs.close()


def test_drain_counters_land_in_registry(catalog):
    s = Session(catalog, seed=5, config=NOCACHE_CFG)
    s.submit(HERD_SQL)
    s.submit(HERD_SQL)
    s.drain()
    assert s.metrics.counter("pilotdb_drains_total").value == 1
    assert s.metrics.counter("pilotdb_drained_queries_total").value == 2
    assert s.metrics.histogram("pilotdb_drain_wall_seconds").count == 1
    s.close()


# ---------------------------------------------------------------------------
# Guarantee auditor
# ---------------------------------------------------------------------------

def test_audit_mode_bit_identical_and_honest(catalog):
    plain = Session(catalog, seed=7, config=SERIAL_CFG).sql(HERD_SQL)
    s = Session(catalog, seed=7, config=SessionConfig(
        **SERIAL, tracing=True, audit=True))
    runs0 = s.executor.queries_run
    h = s.sql(HERD_SQL)
    _assert_bitwise(h.answer, plain.answer)
    rec = h.audit_record
    assert rec is not None and rec.skipped is None
    assert rec.passed and rec.observed_error <= rec.promised_error
    assert 0.0 <= rec.error_ratio <= 1.0
    assert rec.provenance == "fresh"
    summ = s.auditor.summary()
    assert summ["runs"] == 1 and summ["violations"] == 0
    assert summ["max_error_ratio"] == rec.error_ratio
    assert s.metrics.histogram("pilotdb_audit_error_ratio").count == 1
    assert s.metrics.gauge(
        "pilotdb_audit_max_error_ratio").value == rec.error_ratio
    # the exact run is one more executor query, outside the result cache
    assert s.executor.queries_run - runs0 == 2
    assert s.result_cache_info().size == 0


def test_audit_skips_exact_answers_without_second_scan(catalog):
    s = Session(catalog, seed=7, config=SessionConfig(audit=True))
    h = s.sql("SELECT COUNT(*) AS n FROM lineitem")  # no spec: exact
    rec = h.audit_record
    assert rec.skipped == "answer is exact"
    assert rec.observed_error == 0.0 and rec.passed
    assert rec.exact_wall_s == 0.0
    assert s.auditor.summary()["skipped_exact"] == 1
    s.close()


def test_audit_grouped_checks_every_covered_group(catalog):
    s = Session(catalog, seed=21, config=SessionConfig(**SERIAL, audit=True))
    h = s.sql(GROUPED_SQL)
    rec = h.audit_record
    if h.fallback is None:
        assert rec.skipped is None
        assert rec.groups_checked >= 1
        assert rec.passed


def test_audit_never_raises_into_query_path(catalog, monkeypatch):
    s = Session(catalog, seed=7, config=SessionConfig(**SERIAL, audit=True))

    def broken_exact(self, q):
        raise RuntimeError("audit scan died")

    monkeypatch.setattr(PilotDB, "exact", broken_exact)
    h = s.sql(HERD_SQL)
    assert h.status == "done"
    assert h.audit_record is None
    assert s.auditor.summary()["errors"] == 1
    assert s.metrics.counter("pilotdb_audit_errors_total").value == 1


def test_explain_reports_guarantee_and_audit(catalog):
    s = Session(catalog, seed=7, config=SessionConfig(
        **SERIAL, tracing=True, audit=True))
    h = s.sql(HERD_SQL)
    text = h.explain()
    assert f"Query {h.query_id}:" in text
    assert "ERROR 8% CONFIDENCE 95%" in text
    assert "provenance: fresh" in text
    assert "pilot: table=lineitem" in text
    assert "solved rates" in text
    assert "audit: observed=" in text and "[OK]" in text


def test_explain_failed_handle(catalog):
    s = Session(catalog, seed=3)
    h = s.failed_handle("SELEKT 1", "SqlSyntaxError: nope")
    text = h.explain()
    assert "FAILED" in text and "SqlSyntaxError" in text
    s.close()


def test_global_registry_exists():
    assert isinstance(GLOBAL.to_text(), str)


def test_prometheus_help_escaping_and_duplicate_guard():
    reg = MetricsRegistry()
    reg.counter("dup_hits", "line one\nline two with \\ backslash").inc(3)
    reg.register_collector("dup", lambda: {"hits": 99, "fresh": 7})
    reg.histogram("lat_seconds", buckets=(0.1,)).observe(0.05)
    reg.register_collector("lat", lambda: {"seconds_count": 42})
    text = reg.to_text()
    for line in text.splitlines():
        assert line.startswith("#") or len(line.split()) == 2, line
    assert ("# HELP dup_hits line one\\nline two with \\\\ backslash"
            in text.splitlines())
    dup_lines = [ln for ln in text.splitlines()
                 if ln.split()[0] == "dup_hits"]
    assert dup_lines == ["dup_hits 3"]
    assert "dup_fresh 7" in text
    count_lines = [ln for ln in text.splitlines()
                   if ln.split()[0] == "lat_seconds_count"]
    assert count_lines == ["lat_seconds_count 1"]


# ---------------------------------------------------------------------------
# Continuous telemetry: time-series, SLO, flight recorder, sampled tracing
# ---------------------------------------------------------------------------

def _telemetry_cfg(tmp_path=None, **kw):
    base = dict(async_workers=4, result_cache_size=0, telemetry=True)
    if tmp_path is not None:
        base["flight_recorder"] = str(tmp_path / "events.jsonl")
    base.update(kw)
    return SessionConfig(**base)


def test_ring_and_quantile_mechanics():
    r = Ring(4)
    assert r.stats()["window"] == 0 and r.last() == 0.0
    for v in [5.0, 1.0, 3.0]:
        r.push(v)
    assert r.values() == [5.0, 1.0, 3.0] and r.last() == 3.0
    for v in [7.0, 9.0]:
        r.push(v)
    assert r.values() == [1.0, 3.0, 7.0, 9.0]
    assert r.last() == 9.0 and r.total == 5
    st = r.stats()
    assert st["p50"] == 3.0 and st["p99"] == 9.0 and st["max"] == 9.0
    assert quantile([], 0.5) == 0.0
    assert quantile([2.0, 1.0], 0.5) == 1.0
    with pytest.raises(ValueError):
        Ring(0)


def test_timeseries_store_eviction_and_slo_stats():
    ts = TemplateTimeSeries(window=8, max_templates=2)
    ts.record_delivery("a", latency_s=0.1, fallback=True)
    ts.record_delivery("b", latency_s=0.2)
    ts.record_delivery("a", latency_s=0.3)
    ts.record_delivery("c", latency_s=0.4)  # evicts b (LRU)
    assert set(ts.keys()) == {"a", "c"}
    st = ts.slo_stats("a")
    assert st["samples"] == 2 and st["fallback_rate"] == 0.5
    ts.record_audit("a", 0.7, passed=False)
    assert ts.slo_stats("a")["violation_rate"] == 1.0
    ts.record_drain(0.01, 0.05)
    ts.record_drain(None, None)
    snap = ts.snapshot()
    assert snap["drains"] == 2 and snap["ttff_s"]["window"] == 1
    json.dumps(snap)


def test_telemetry_off_by_default_and_bit_identical_on(catalogs, tmp_path):
    ref_cat, catalog = catalogs
    plain = Session(catalog, seed=17, config=NOCACHE_CFG)
    assert plain.timeseries is None and plain.slo is None
    assert plain.recorder is None
    ph = [plain.submit(TEMPLATE_SQL.format(c)) for c in (18, 24, 30)]
    plain.drain()

    cfg = _telemetry_cfg(tmp_path, trace_sample=1.0,
                         slo_targets=(SloTarget(p95_latency_s=3600.0),))
    tele = Session(catalog, seed=17, config=cfg)
    th = [tele.submit(TEMPLATE_SQL.format(c)) for c in (18, 24, 30)]
    tele.drain()
    for a, b in zip(ph, th):
        _assert_bitwise(a.answer, b.answer)
    assert len(tele.timeseries.keys()) == 1  # one constant-varied template
    key = tele.timeseries.keys()[0]
    assert key == tele.template_key(TEMPLATE_SQL.format(18))
    s = tele.timeseries.series(key)
    assert s.deliveries == 3 and len(s.latency_s) == 3
    assert s.failures == 0
    # the template key is the reference's: the plan repr is the same
    rs = ref_api.Session(ref_cat, seed=17)
    assert key == rs.template_key(TEMPLATE_SQL.format(18))
    rs.close()
    tele.close()
    plain.close()


def test_slo_breach_round_trip(catalog, tmp_path):
    """An impossible target -> breach counter + flight-recorder event +
    report row (the session half of the reference's case)."""
    cfg = _telemetry_cfg(
        tmp_path, slo_targets=(SloTarget(p95_latency_s=1e-9),
                               SloTarget(max_fallback_rate=0.99)))
    s = Session(catalog, seed=5, config=cfg)
    s.submit(HERD_SQL)
    s.drain()
    assert s.metrics.counter("pilotdb_slo_breaches_total").value >= 1
    assert s.metrics.counter("pilotdb_slo_evaluations_total").value >= 2
    rows = s.slo.report()
    breached = [r for r in rows if r["breached"]]
    assert breached and breached[0]["metric"] == "p95_latency_s"
    assert breached[0]["observed"] > breached[0]["target"]
    assert breached[0]["breaches_total"] >= 1
    ok = [r for r in rows if r["metric"] == "max_fallback_rate"]
    assert ok and not ok[0]["breached"]
    summary = s.slo.summary()
    assert summary["enabled"] and summary["recent_breaches"]
    s.close()
    events = list(replay(str(tmp_path / "events.jsonl")))
    assert any(e["ev"] == "slo_breach"
               and e["metric"] == "p95_latency_s" for e in events)


def test_slo_targets_require_telemetry(catalog):
    with pytest.raises(ValueError, match="telemetry"):
        Session(catalog, seed=5, config=SessionConfig(
            slo_targets=(SloTarget(p95_latency_s=1.0),)))


def test_slo_per_template_rule_matches_only_its_template(catalog, tmp_path):
    s = Session(catalog, seed=5, config=_telemetry_cfg(tmp_path))
    other = "SELECT COUNT(*) AS n FROM lineitem"
    key = s.template_key(HERD_SQL)
    s.slo.set_target(template=key, p95_latency_s=1e-9)
    s.submit(HERD_SQL)
    s.submit(other)
    s.drain()
    rows = s.slo.report()
    assert all(r["template"] == key for r in rows)
    assert any(r["breached"] for r in rows)
    s.close()


def test_flight_recorder_event_schema_and_replay(catalogs, tmp_path):
    ref_cat, catalog = catalogs
    path = tmp_path / "events.jsonl"
    s = Session(catalog, seed=5, config=_telemetry_cfg(tmp_path))
    s.submit(HERD_SQL)
    s.submit("SELECT COUNT(*) AS n FROM lineitem")  # exact: no pilot
    s.drain()
    s.close()
    events = list(replay(str(path)))
    kinds = [e["ev"] for e in events]
    assert kinds.count("submit") == 2
    assert kinds.count("deliver") == 2
    assert "pilot" in kinds and "rate_solve" in kinds and "final" in kinds
    seqs = [e["seq"] for e in events]
    assert seqs == sorted(seqs) and len(set(seqs)) == len(seqs)
    assert all(e["t"] > 0 for e in events)
    deliver = [e for e in events if e["ev"] == "deliver"
               and e["template"] == s.template_key(HERD_SQL)]
    assert deliver
    d = deliver[0]
    assert d["latency_s"] > 0 and d["scanned_bytes"] > 0
    assert d["fallback"] is False and d["cached"] is False
    live = s.timeseries
    rebuilt = rebuild_timeseries(replay(str(path)))
    assert set(rebuilt.keys()) == set(live.keys())
    for key in live.keys():
        a, b = live.series(key), rebuilt.series(key)
        assert (a.deliveries, a.cached, a.shared, a.fused, a.fallbacks,
                a.failures) == (b.deliveries, b.cached, b.shared, b.fused,
                                b.fallbacks, b.failures)
        assert b.latency_s.values() == pytest.approx(
            a.latency_s.values(), abs=1e-6)


def test_flight_recorder_herd_event_sequence_matches_reference(
        catalogs, tmp_path):
    """One constant-varied herd (one drain group, three pilot subgroups,
    batched finals): the port's recorder logs the reference's event types
    in the reference's order, with the same templates and query ids."""
    ref_cat, catalog = catalogs
    cfg = dict(async_workers=2, pilot_workers=0, result_cache_size=0,
               telemetry=True)

    def run(make, cat, sub):
        path = tmp_path / sub / "events.jsonl"
        os.makedirs(path.parent)
        s = make(cat, seed=17, config=SessionConfig(**cfg,
                                                   flight_recorder=str(path))
                 if make is Session else ref_api.SessionConfig(
                     **cfg, flight_recorder=str(path)))
        hs = [s.submit(TEMPLATE_SQL.format(c)) for c in (18, 24, 30)]
        s.drain()
        s.close()
        events = list((replay if make is Session else ref_replay)(str(path)))
        return hs, [(e["ev"], e.get("qid"), e.get("template"))
                    for e in events]

    hs, port_seq = run(Session, catalog, "port")
    _, ref_seq = run(ref_api.Session, ref_cat, "ref")
    assert [e[0] for e in port_seq] == [e[0] for e in ref_seq]
    assert port_seq == ref_seq
    assert all(h.status == "done" for h in hs)


def test_rebuild_skips_audits_that_did_not_run(catalog, tmp_path):
    """An exact answer's audit is skipped: logged, but never in the live
    series, and the port's offline rebuild leaves it out too (the
    reference's rebuild counts it, so its rebuilt ``audited`` exceeds the
    live one)."""
    path = tmp_path / "events.jsonl"
    s = Session(catalog, seed=7, config=SessionConfig(
        **SERIAL, telemetry=True, audit=True, flight_recorder=str(path)))
    exact = s.sql("SELECT SUM(l_quantity) AS q FROM lineitem")
    approx = s.sql(HERD_SQL)
    assert exact.audit_record.skipped == "answer is exact"
    assert approx.audit_record.skipped is None
    s.close()
    assert [e["ev"] for e in replay(str(path))].count("audit") == 2
    rebuilt = rebuild_timeseries(str(path))
    assert set(rebuilt.keys()) == set(s.timeseries.keys())
    for key in s.timeseries.keys():
        a, b = s.timeseries.series(key), rebuilt.series(key)
        assert (a.deliveries, a.fallbacks, a.audited, a.audit_violations) == \
            (b.deliveries, b.fallbacks, b.audited, b.audit_violations)
        assert b.error_ratio.values() == pytest.approx(
            a.error_ratio.values(), abs=1e-6)


def test_flight_recorder_unwritable_target_never_raises(catalog):
    cfg = SessionConfig(
        **SERIAL,
        flight_recorder="/nonexistent-dir-for-pilotdb-tests/events.jsonl")
    plain = Session(catalog, seed=7, config=SERIAL_CFG).sql(HERD_SQL)
    s = Session(catalog, seed=7, config=cfg)
    h = s.sql(HERD_SQL)
    assert h.status == "done"
    _assert_bitwise(h.answer, plain.answer)
    assert s.recorder.stats()["dropped"] > 0
    assert s.recorder.stats()["emitted"] == 0
    s.close()


def test_flight_recorder_rotation_mid_drain(catalog, tmp_path):
    path = tmp_path / "tiny.jsonl"
    cfg = _telemetry_cfg(None, flight_recorder=str(path),
                         flight_recorder_max_bytes=1024,
                         flight_recorder_max_files=2)
    plain = Session(catalog, seed=13, config=NOCACHE_CFG)
    ph = [plain.submit(TEMPLATE_SQL.format(c)) for c in (18, 24, 30, 36)]
    plain.drain()
    s = Session(catalog, seed=13, config=cfg)
    th = [s.submit(TEMPLATE_SQL.format(c)) for c in (18, 24, 30, 36)]
    s.drain()
    for a, b in zip(ph, th):
        _assert_bitwise(a.answer, b.answer)
    stats = s.recorder.stats()
    assert stats["rotations"] >= 1 and stats["dropped"] == 0
    s.close()
    assert path.exists() and (tmp_path / "tiny.jsonl.1").exists()
    events = list(replay(str(path)))
    assert events and all("ev" in e for e in events)
    plain.close()


def test_flight_recorder_mid_group_failure_logs_terminal_event(
        catalog, tmp_path, monkeypatch):
    path = tmp_path / "events.jsonl"
    s = Session(catalog, seed=5, config=_telemetry_cfg(tmp_path))
    _flaky_prepare(monkeypatch, PilotDB)
    handles = [s.submit(x) for x in MID_GROUP]
    s.drain()
    assert [h.status for h in handles] == ["done", "failed", "done"]
    key = s.template_key(MID_GROUP[0])
    series = s.timeseries.series(key)
    assert series.deliveries == 3 and series.failures == 1
    s.close()
    events = list(replay(str(path)))
    fails = [e for e in events if e["ev"] == "fail"]
    assert len(fails) == 1
    assert fails[0]["qid"] == handles[1].query_id
    assert "worker exploded" in fails[0]["error"]
    assert sum(1 for e in events if e["ev"] == "deliver") == 2


def test_trace_sampling_deterministic_and_content_derived(catalogs):
    ref_cat, catalog = catalogs
    cuts = list(range(10, 40, 3))

    def sampled_set(make, cat, cfg, seed):
        s = make(cat, seed=seed, config=cfg)
        out = {}
        for c in cuts:
            h = s.sql(TEMPLATE_SQL.format(c))
            out[c] = h._trace_sampled
            assert (h._trace is not None) == h._trace_sampled
        s.close()
        return out

    cfg = SessionConfig(**SERIAL, trace_sample=0.5)
    first = sampled_set(Session, catalog, cfg, 23)
    again = sampled_set(Session, catalog, cfg, 23)
    assert first == again  # equal seeds sample the IDENTICAL query set
    assert any(first.values()) and not all(first.values())
    other = sampled_set(Session, catalog, cfg, 24)
    assert other != first  # the decision hashes the session seed too
    # the decision is the reference's, query for query
    ref_cfg = ref_api.SessionConfig(**SERIAL, trace_sample=0.5)
    assert first == sampled_set(ref_api.Session, ref_cat, ref_cfg, 23)


def test_trace_sample_bounds_and_edges(catalog):
    with pytest.raises(ValueError, match="trace_sample"):
        Session(catalog, seed=3, config=SessionConfig(trace_sample=1.5))
    s0 = Session(catalog, seed=3, config=SessionConfig(**SERIAL,
                                                       trace_sample=0.0))
    assert s0.sql(HERD_SQL)._trace is None
    s1 = Session(catalog, seed=3, config=SessionConfig(**SERIAL,
                                                       trace_sample=1.0))
    h = s1.sql(HERD_SQL)
    assert h._trace_sampled and h._trace is not None
    assert len(s1.recent_traces) == 1
    assert s1.recent_traces[0]["query_id"] == h.query_id
    s0.close()
    s1.close()


def test_sampled_traces_land_in_flight_recorder(catalog, tmp_path):
    path = tmp_path / "events.jsonl"
    cfg = SessionConfig(**SERIAL, trace_sample=1.0,
                        flight_recorder=str(path))
    s = Session(catalog, seed=3, config=cfg)
    h = s.sql(HERD_SQL)
    s.close()
    events = list(replay(str(path)))
    traces = [e for e in events if e["ev"] == "trace"]
    assert len(traces) == 1
    tree = traces[0]["trace"]
    assert tree["query_id"] == h.query_id
    assert tree["root"]["name"] == "query"
    subs = [e for e in events if e["ev"] == "submit"]
    assert subs and subs[0]["sampled"] is True


def test_audit_feeds_timeseries_and_recorder(catalog, tmp_path):
    path = tmp_path / "events.jsonl"
    cfg = SessionConfig(**SERIAL, telemetry=True, audit=True,
                        flight_recorder=str(path))
    s = Session(catalog, seed=7, config=cfg)
    h = s.sql(HERD_SQL)
    rec = h.audit_record
    assert rec is not None and rec.skipped is None
    key = s.template_key(HERD_SQL)
    series = s.timeseries.series(key)
    assert series.audited == 1
    assert series.error_ratio.last() == pytest.approx(rec.error_ratio)
    assert series.audit_violations == (0 if rec.passed else 1)
    s.close()
    audits = [e for e in list(replay(str(path))) if e["ev"] == "audit"]
    assert len(audits) == 1
    assert audits[0]["passed"] == rec.passed
    assert audits[0]["ratio"] == pytest.approx(rec.error_ratio, abs=1e-6)
    # every recorded field is a plain JSON scalar, list or dict
    for line in path.read_text().splitlines():
        json.loads(line)


def test_fused_provenance_in_explain_and_timeseries(catalogs):
    """Audit mode + fused_taqa: explain() reports the fused span, the
    provenance gains +fused, the time-series counts the fused delivery, the
    audit passes on the fused answer, and the span tree is the
    reference's."""
    ref_cat, catalog = catalogs
    cfg = dict(async_workers=0, result_cache_size=0, telemetry=True,
               audit=True, tracing=True, fused_taqa=True)
    plain = Session(catalog, seed=7, config=SERIAL_CFG).sql(HERD_SQL)
    s = Session(catalog, seed=7, config=SessionConfig(**cfg))
    h = s.submit(HERD_SQL)
    s.drain()
    assert h.status == "done"
    _assert_bitwise(h.answer, plain.answer)
    fused_spans = h._trace.find("fused")
    assert fused_spans and fused_spans[0].attrs["engaged"]  # the port fuses
    assert "+fused" in provenance_of(h)
    assert "fused: engaged" in h.explain()
    key = s.template_key(HERD_SQL)
    assert s.timeseries.series(key).fused == 1
    rec = h.audit_record
    assert rec is not None and rec.passed
    s.close()
    rs = _ref_session(ref_cat, 7, **cfg)
    r = rs.submit(HERD_SQL)
    rs.drain()
    assert r._fused
    assert _tree(h._trace) == _tree(r._trace)
    rs.close()


@pytest.mark.parametrize("shape", ["exact", "grouped", "fused_sql"])
def test_all_hooks_on_bitwise_and_trees_match_reference(catalogs, tmp_path,
                                                        shape):
    """Every hook on at once (tracing, audit, telemetry, sampling, the
    recorder, an SLO) against every hook off, on shapes the cases above do
    not cover: bitwise answers, and the reference's span tree."""
    ref_cat, catalog = catalogs
    sql, extra = {"exact": ("SELECT SUM(l_quantity) AS q FROM lineitem", {}),
                  "grouped": (GROUPED_SQL, {}),
                  "fused_sql": (HERD_SQL, {"fused_taqa": True})}[shape]
    hooks = dict(tracing=True, audit=True, telemetry=True, trace_sample=1.0,
                 slo_targets=(SloTarget(p95_latency_s=3600.0),))
    off = Session(catalog, seed=19, config=SessionConfig(**SERIAL, **extra))
    on = Session(catalog, seed=19, config=SessionConfig(
        **SERIAL, **extra, **hooks,
        flight_recorder=str(tmp_path / "on.jsonl")))
    a, b = off.sql(sql, stream=False), on.sql(sql, stream=True)
    _assert_bitwise(a.answer, b.answer)
    assert b.frames()[-1].answer is b.answer
    assert b._trace.open_spans() == []
    rs = _ref_session(ref_cat, 19, **SERIAL, **extra, **hooks,
                      flight_recorder=str(tmp_path / "ref.jsonl"))
    r = rs.sql(sql, stream=True)
    assert _tree(b._trace) == _tree(r._trace)
    assert [f.kind for f in b.frames()] == [f.kind for f in r.frames()]
    on.close()
    rs.close()
