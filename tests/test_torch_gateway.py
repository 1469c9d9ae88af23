"""The port's SQL gateway and dashboard (``repro_torch.serve``) held to the
reference's, on the CPU.

The reference's gateway cases (``tests/test_serve.py``) and the ones that
waited for the port's gateway (``tests/test_staged.py``,
``tests/test_stream.py``, ``tests/test_obs.py``) run here by name on the
port, each beside the reference gateway on the same data: both packages
build ``tpch_catalog(scale_rows=200_000, block_rows=32, seed=0)`` from one
numpy seed (the port's with ``device="cpu"``) and answer the same requests
in the same order on equal-seed sessions.  Against the reference: equal
tickets, statuses, failure classes, fallbacks, cache provenance and gateway
counters; sampling rates within rtol 1e-6; approximate answers within rtol
1e-5 (pilot block sums are f32 sums whose last bit may differ); exact
answers against an f64 sum of the same rows (the reference's exact f32 sum
can be 1.4e-5 off at this size: ROADMAP queue 3).  ``stats_payload``'s key
tree must be the reference's, key for key.

The reference's own frame-bound case fails by the thread interleaving of
its drain (ROADMAP queue 3); here the order of a serial drain is pinned.
"""

import json

import numpy as np
import pytest

import repro.api as ref_api
from repro.engine.datagen import tpch_catalog as ref_tpch_catalog
from repro.obs.slo import SloTarget as RefSloTarget
from repro.serve.dashboard import render_dashboard as ref_render_dashboard
from repro.serve.sql_gateway import SqlGateway as RefGateway
from repro_torch.api import (BackpressureError, ErrorFrame, FinalFrame,
                             PilotFrame, Session, SessionConfig)
from repro_torch.engine.datagen import tpch_catalog
from repro_torch.obs.events import replay
from repro_torch.obs.slo import SloTarget
from repro_torch.serve import SqlGateway, render_dashboard, write_dashboard

HERD_SQL = ("SELECT SUM(l_extendedprice * l_discount) AS rev FROM lineitem "
            "WHERE l_quantity < 24 ERROR 8% CONFIDENCE 95%")
DASH_SQL = ("SELECT SUM(l_extendedprice * l_discount) AS rev FROM lineitem "
            "WHERE l_quantity < 24 ERROR 10% CONFIDENCE 90%")


@pytest.fixture(scope="module")
def catalogs():
    return (ref_tpch_catalog(scale_rows=200_000, block_rows=32, seed=0),
            tpch_catalog(scale_rows=200_000, block_rows=32, seed=0, device="cpu"))


@pytest.fixture(scope="module")
def sessions(catalogs):
    """The reference's module-wide ``aqp_session`` and the port's twin: the
    cases below drive both through the same requests in the same order."""
    ref, port = catalogs
    rs, ps = ref_api.Session(ref, seed=5), Session(port, seed=5, device="cpu")
    yield rs, ps
    rs.close()
    ps.close()


def _gateways(sessions, **kw):
    rs, ps = sessions
    return RefGateway(rs, **kw), SqlGateway(ps, **kw)


def _exact_f64(catalog):
    """f64 answers of the unfiltered exact aggregates the cases ask for, by
    output name."""
    li = catalog["lineitem"]
    valid = li.valid.numpy()
    return {"n": float(valid.sum()),
            "q": float(li.columns["l_quantity"].numpy()[valid].astype(np.float64).sum())}


def _same_answer(h, rh):
    assert (h.status, h.cached, h.fallback) == (rh.status, rh.cached, rh.fallback)
    rep, rrep = h.report, rh.report
    assert (rep is None) == (rrep is None)
    if rep is not None and rep.plan is not None:
        assert rrep.plan is not None
        for t, r in rep.plan.rates.items():
            assert r == pytest.approx(rrep.plan.rates[t], rel=1e-6)
        np.testing.assert_allclose(h.answer.values, rh.answer.values, rtol=1e-5)
    else:
        assert rrep is None or rrep.plan is None
    assert list(h.answer.names) == list(rh.answer.names)


def _same_results(catalog, got, want):
    """Ticket for ticket: statuses, failure classes and answers; an exact
    answer of an unfiltered aggregate against its f64 sum."""
    assert sorted(got) == sorted(want)
    for t, h in got.items():
        rh = want[t]
        assert h.status == rh.status, (t, h.error, rh.error)
        if h.status == "failed":
            assert h.error.split(":")[0] == rh.error.split(":")[0]
            continue
        _same_answer(h, rh)
        if (h.report is None or h.report.plan is None) and "WHERE" not in h.sql:
            truth = _exact_f64(catalog)
            for i, name in enumerate(h.answer.names):
                np.testing.assert_allclose(h.answer.values[0, i], truth[name], rtol=1e-6)


def _counters(gw):
    return gw.stats.as_dict()


def _key_tree(d):
    return {k: _key_tree(v) if isinstance(v, dict) else type(v).__name__
            for k, v in d.items()}


# -- the reference's tests/test_serve.py gateway cases ------------------------

def test_gateway_serves_many_clients_warm(catalogs, sessions):
    """A herd of identical dashboard queries from different clients runs as
    one signature group: ONE pilot stage, one final, and every other ticket
    answered from the session result cache with the original report."""
    rgw, gw = _gateways(sessions)
    tickets = {}
    for g in (rgw, gw):
        tickets[g] = {g.submit(f"client{i}", DASH_SQL): f"client{i}" for i in range(8)}
        assert len(g.results_for("client3")) == 1  # queued, not yet delivered
    assert tickets[gw] == tickets[rgw]
    want, results = rgw.run(), gw.run()
    assert set(results) == set(tickets[gw])
    assert all(h.status == "done" for h in results.values())
    assert gw.stats.served == 8 and gw.stats.rejected == 0
    assert gw.stats.pilots_run == 1
    assert gw.stats.result_hits == 7
    assert len({h.scalar("rev") for h in results.values()}) == 1
    _same_results(catalogs[1], results, want)
    assert gw.results_for("client3") == [] and gw.run() == {}
    # the SAME dashboard re-issued later answers entirely from cache
    t2, rt2 = gw.submit("client0", DASH_SQL), rgw.submit("client0", DASH_SQL)
    out2, rout2 = gw.run(), rgw.run()
    assert t2 == rt2 and out2[t2].cached
    assert out2[t2].scalar("rev") == results[min(results)].scalar("rev")
    _same_results(catalogs[1], out2, rout2)
    assert _counters(gw) == _counters(rgw)


def test_gateway_bad_sql_fails_only_that_ticket(catalogs, sessions):
    requests = [
        ("alice", "SELECT COUNT(*) AS n FROM lineitem"),
        ("bob", "SELEKT COUNT(*) FROM lineitem"),
        ("eve", "SELECT COUNT(*) AS n FROM not_a_table GROUP BY g"),
        ("mallory", "SELECT COUNT(*) AS n FROM lineitem ERROR 150% CONFIDENCE 95%"),
        ("trudy", "SELECT COUNT(*) AS n FROM lineitem WHERE "
         + " AND ".join(["l_quantity < 24"] * 2000)),
    ]
    rgw, gw = _gateways(sessions)
    tickets = [gw.submit(c, sql) for c, sql in requests]
    assert tickets == [rgw.submit(c, sql) for c, sql in requests]
    results, want = gw.run(), rgw.run()
    good, bad, missing, out_of_range, deep = tickets
    assert results[good].status == "done" and results[good].scalar("n") == 200_000
    assert results[bad].status == "failed"
    assert "SqlSyntaxError" in results[bad].error
    assert results[missing].status == "failed"
    assert results[out_of_range].status == "failed"
    assert results[deep].status == "failed"
    assert gw.stats.rejected >= 2 and gw.stats.requests == 5
    _same_results(catalogs[1], results, want)
    assert _counters(gw) == _counters(rgw)


def test_gateway_rejects_degenerate_batch_size(sessions):
    for kw in (dict(batch_size=0), dict(max_pending=0),
               dict(max_inflight_per_client=0), dict(max_frames_per_client=0)):
        with pytest.raises(ValueError):
            SqlGateway(sessions[1], **kw)


def test_gateway_batched_drains(catalogs, sessions):
    rgw, gw = _gateways(sessions, batch_size=3)
    sql = "SELECT SUM(l_quantity) AS q FROM lineitem ERROR 10% CONFIDENCE 90%"
    for g in (rgw, gw):
        for i in range(7):
            g.submit(f"c{i}", sql)
    results, want = gw.run(), rgw.run()
    assert len(results) == 7
    assert gw.stats.drains >= 3  # 3 + 3 + 1 under batch_size=3
    _same_results(catalogs[1], results, want)
    assert _counters(gw) == _counters(rgw)


def test_gateway_backpressure_bounded_admission(catalogs, sessions):
    sql = "SELECT COUNT(*) AS n FROM lineitem"
    rgw, gw = _gateways(sessions, max_pending=3)
    for g, err in ((rgw, ref_api.BackpressureError), (gw, BackpressureError)):
        for i in range(3):
            g.submit(f"c{i}", sql)
        with pytest.raises(err, match="admission queue full"):
            g.submit("c3", sql)
    assert gw.stats.throttled == 1
    assert gw.stats.requests == 3   # a throttled request never became one
    results, want = gw.run(), rgw.run()
    assert len(results) == 3
    _same_results(catalogs[1], results, want)
    t, rt = gw.submit("c3", sql), rgw.submit("c3", sql)
    assert gw.run()[t].status == "done" and rgw.run()[rt].status == "done"
    assert _counters(gw) == _counters(rgw)


def test_gateway_admission_budget_isolated_per_gateway(sessions):
    """One gateway's queued work must not consume another's max_pending."""
    for (session, err, gw_cls) in ((sessions[0], ref_api.BackpressureError, RefGateway),
                                   (sessions[1], BackpressureError, SqlGateway)):
        gw1 = gw_cls(session)
        gw2 = gw_cls(session, max_pending=1)
        gw1.submit("a", "SELECT COUNT(*) AS n FROM orders")
        gw1.submit("a", "SELECT COUNT(*) AS n FROM lineitem")
        t = gw2.submit("b", "SELECT COUNT(*) AS n FROM orders")
        with pytest.raises(err):
            gw2.submit("b", "SELECT COUNT(*) AS n FROM lineitem")
        gw1.run()
        assert gw2.run()[t].status == "done"


def test_gateway_backpressure_per_client_cap(sessions):
    rgw, gw = _gateways(sessions, max_inflight_per_client=2)
    sql = "SELECT COUNT(*) AS n FROM lineitem"
    for g, err in ((rgw, ref_api.BackpressureError), (gw, BackpressureError)):
        g.submit("greedy", sql)
        g.submit("greedy", sql)
        with pytest.raises(err, match="greedy"):
            g.submit("greedy", sql)
    t = gw.submit("polite", sql)  # the cap is per client
    rgw.submit("polite", sql)
    results, _ = gw.run(), rgw.run()
    assert t in results and gw.stats.throttled == 1
    assert _counters(gw) == _counters(rgw)


def test_gateway_stats_payload_one_stop(sessions):
    """stats_payload() surfaces the gateway counters, the compile-cache
    counters and the result-cache hit and byte counters in one payload."""
    rs, ps = sessions
    rgw, gw = _gateways(sessions)
    sql = ("SELECT SUM(l_quantity) AS q FROM lineitem "
           "WHERE l_quantity < 30 ERROR 10% CONFIDENCE 90%")
    for g in (rgw, gw):
        for i in range(3):
            g.submit(f"c{i}", sql)
        g.run()
    payload, rpayload = gw.stats_payload(), rgw.stats_payload()
    assert payload["gateway"]["requests"] == gw.stats.requests == 3
    assert payload["gateway"]["served"] == 3
    info = ps.compile_cache_info()
    assert payload["compile_cache"] == {
        "hits": info.hits, "misses": info.misses, "size": info.size,
        "staged_hits": info.staged_hits, "staged_misses": info.staged_misses,
        "pilot_hits": info.pilot_hits, "pilot_misses": info.pilot_misses,
        "batched_hits": info.batched_hits,
        "batched_misses": info.batched_misses,
        "fused_hits": info.fused_hits, "fused_misses": info.fused_misses,
        "shared_hits": info.shared_hits}
    rc = ps.result_cache_info()
    assert payload["result_cache"]["hits"] == rc.hits >= 2
    assert payload["result_cache"]["bytes_used"] == rc.bytes_used > 0
    assert payload["result_cache"]["capacity"] == rc.capacity
    assert payload["shard_scanned_bytes"] == {}
    assert payload["staged"]["hits"] == 0 and payload["staged"]["tables"] == {}
    assert payload["timeseries"]["enabled"] is False
    assert payload["slo"]["enabled"] is False
    # against the reference: the same gateway and result-cache numbers
    assert payload["gateway"] == rpayload["gateway"]
    for k in ("hits", "misses", "size", "capacity", "bytes_used", "evictions"):
        assert payload["result_cache"][k] == rpayload["result_cache"][k], k
    assert _key_tree(payload) == _key_tree(rpayload)


def test_gateway_stats_payload_key_tree_is_the_references(sessions):
    """The payload schema, key for key and type for type, recursively: the
    reference's pinned contract, here with telemetry, a flight recorder and
    an SLO on, and on a cold gateway."""
    rs, ps = sessions
    rgw, gw = _gateways(sessions)
    assert _key_tree(gw.stats_payload()) == _key_tree(rgw.stats_payload())
    for g in (rgw, gw):
        g.submit("c0", "SELECT SUM(l_quantity) AS q FROM lineitem "
                       "WHERE l_quantity < 30 ERROR 10% CONFIDENCE 90%")
        g.run()
    payload = gw.stats_payload()
    assert _key_tree(payload) == _key_tree(rgw.stats_payload())
    json.dumps(payload)
    tree = ps.metrics.tree()
    for k in ("compile_cache", "result_cache", "runtime"):
        assert payload[k] == tree[k]


def test_gateway_metrics_text_prometheus(sessions):
    rgw, gw = _gateways(sessions)
    for g in (rgw, gw):
        g.submit("c0", "SELECT COUNT(*) AS n FROM lineitem")
        g.run()
    text = gw.metrics_text()
    assert text.endswith("\n")
    for line in text.splitlines():
        assert line.startswith("#") or len(line.split()) == 2
    assert f"{gw._collector_name}_served 1" in text
    assert "compile_cache_hits" in text
    names = {line.split()[0] for line in text.splitlines() if not line.startswith("#")}
    rnames = {line.split()[0] for line in rgw.metrics_text().splitlines()
              if not line.startswith("#")}
    strip = lambda ns: {n for n in ns if not n.startswith("gateway_")}
    assert strip(names) == strip(rnames)


def test_gateway_stats_payload_shard_attribution(catalogs):
    """With a partitioned registration the payload carries per-shard
    sampled-slab bytes that sum to the monolithic attribution, the
    reference's numbers."""
    out = []
    for api, make in ((ref_api, lambda: ref_tpch_catalog(24_000, 64, seed=0)),
                      (None, lambda: tpch_catalog(24_000, 64, seed=0, device="cpu"))):
        if api is None:
            session = Session(seed=5, device="cpu",
                              config=SessionConfig(large_table_rows=10_000))
            gw_cls = SqlGateway
        else:
            session = api.Session(seed=5, config=api.SessionConfig(large_table_rows=10_000))
            gw_cls = RefGateway
        session.register_table("lineitem", make()["lineitem"], shards=3)
        gw = gw_cls(session)
        gw.submit("c0", "SELECT SUM(l_quantity) AS q FROM lineitem "
                        "WHERE l_quantity < 30 ERROR 8% CONFIDENCE 90%")
        gw.run()
        per_shard = gw.stats_payload()["shard_scanned_bytes"]["lineitem"]
        assert per_shard == list(session.executor.shard_scan_info()["lineitem"])
        out.append(per_shard)
        session.close()
    assert len(out[1]) == 3 and sum(out[1]) > 0
    assert out[0] == out[1]


# -- the cases that waited for the port's gateway ----------------------------

def test_gateway_payload_staged_section():
    """tests/test_staged.py's case: a staged registration fills the
    payload's staged section."""
    ladder = [0.01, 0.04, 0.16, 0.5]
    sql = ("SELECT SUM(l_extendedprice * l_discount) AS rev FROM lineitem "
           "WHERE l_quantity < 24 ERROR 8% CONFIDENCE 90%")
    session = Session(seed=11, device="cpu", config=SessionConfig(large_table_rows=10_000))
    session.register_table("lineitem", tpch_catalog(24_000, 64, seed=3, device="cpu")["lineitem"],
                           staged_rates=ladder)
    gw = SqlGateway(session)
    gw.submit("c0", sql)
    gw.run()
    staged = gw.stats_payload()["staged"]
    assert staged["hits"] + staged["misses"] > 0
    assert staged["tables"]["lineitem"]["rates"] == ladder
    assert staged["tables"]["lineitem"]["sharded"] is False
    session.close()


def test_gateway_submit_streaming_delivers_frames(catalogs):
    """tests/test_stream.py's case, beside the reference's gateway."""
    sessions = (ref_api.Session(catalogs[0], seed=5),
                Session(catalogs[1], seed=5, device="cpu"))
    rgw, gw = _gateways(sessions)
    tickets = {}
    for g in (rgw, gw):
        tickets[g] = (g.submit_streaming("alice", HERD_SQL), g.submit("bob", HERD_SQL))
    t1, t2 = tickets[gw]
    assert tickets[gw] == tickets[rgw]
    results, want = gw.run(), rgw.run()
    assert results[t1].status == "done" and results[t2].status == "done"
    frames, rframes = gw.frames_for("alice"), rgw.frames_for("alice")
    assert [type(f) for f in frames] == [PilotFrame, FinalFrame]
    assert [f.kind for f in frames] == [f.kind for f in rframes]
    assert frames[1].answer is results[t1].answer
    np.testing.assert_allclose(frames[0].values, rframes[0].values, rtol=1e-5)
    assert gw.frames_for("alice") == []   # delivered once
    assert gw.frames_for("bob") == []     # plain tickets push no frames
    assert (gw.stats.streams, gw.stats.frames_pushed) == (1, 2)
    assert np.array_equal(results[t1].answer.values, results[t2].answer.values)
    _same_results(catalogs[1], results, want)
    assert _counters(gw) == _counters(rgw)
    for s in sessions:
        s.close()


def test_gateway_streaming_parse_failure_is_terminal_frame(catalogs):
    session = Session(catalogs[1], seed=5, device="cpu")
    gw = SqlGateway(session)
    gw.submit_streaming("eve", "SELEKT 1")
    frames = gw.frames_for("eve")
    assert len(frames) == 1 and isinstance(frames[0], ErrorFrame)
    assert gw.stats.rejected == 1
    session.close()


SERIAL = SessionConfig(async_workers=0, share_pilots=False)
FRAME_SQL = ["SELECT SUM(l_quantity) AS q FROM lineitem ERROR 10% CONFIDENCE 90%",
             "SELECT SUM(l_extendedprice) AS r FROM lineitem ERROR 10% CONFIDENCE 90%",
             "SELECT SUM(l_discount) AS d FROM lineitem ERROR 10% CONFIDENCE 90%"]


def test_gateway_frame_queue_bounded_drops_oldest_advisory(catalogs):
    """The frame bound, pinned on a serial drain (no worker threads, so one
    order): each query's pilot and then its final, query after query.  With
    a bound of 2, each later pilot finds the queue full and evicts the
    oldest advisory frame resident (the previous query's pilot); every
    terminal frame stays, past the bound."""
    session = Session(catalogs[1], seed=6, device="cpu", config=SERIAL)
    gw = SqlGateway(session, max_frames_per_client=2)
    tickets = [gw.submit_streaming("c", sql) for sql in FRAME_SQL]
    results = gw.run()
    frames = gw.frames_for("c")
    assert [(f.query_id, f.kind) for f in frames] == [
        (tickets[0], "final"), (tickets[1], "final"),
        (tickets[2], "pilot"), (tickets[2], "final")]
    assert (gw.stats.frames_pushed, gw.stats.frames_dropped) == (6, 2)
    assert all(f.answer is results[f.query_id].answer for f in frames if f.terminal)
    session.close()


def test_gateway_frame_queue_drops_an_advisory_newcomer_behind_terminals(catalogs):
    """When every resident frame is terminal, an advisory arrival is itself
    dropped, and the final after it is still appended."""
    session = Session(catalogs[1], seed=6, device="cpu", config=SERIAL)
    gw = SqlGateway(session, max_frames_per_client=1)
    t0 = gw.submit_streaming("c", FRAME_SQL[0])
    gw.run()
    assert [f.kind for f in gw.frames_for("c", max_frames=1)] == ["pilot"]
    t1 = gw.submit_streaming("c", FRAME_SQL[1])           # finds [final 0]
    gw.run()
    frames = gw.frames_for("c")
    assert [(f.query_id, f.kind) for f in frames] == [(t0, "final"), (t1, "final")]
    assert (gw.stats.frames_pushed, gw.stats.frames_dropped) == (3, 1)
    session.close()


def test_gateway_metrics_text_includes_gateway_counters(catalogs):
    s = Session(catalogs[1], seed=5, device="cpu")
    gw = SqlGateway(s)
    gw.submit("c0", HERD_SQL)
    gw.run()
    text = gw.metrics_text()
    assert f"{gw._collector_name}_requests 1" in text
    assert "compile_cache_hits" in text
    assert "result_cache_bytes_used" in text
    s.close()


def _telemetry_cfg(config_cls, tmp_path, **kw):
    return config_cls(async_workers=4, result_cache_size=0, telemetry=True,
                             flight_recorder=str(tmp_path / "events.jsonl"), **kw)


def test_timeseries_rides_registry_and_stats_payload(catalogs, tmp_path):
    s = Session(catalogs[1], seed=5, device="cpu",
                config=_telemetry_cfg(SessionConfig, tmp_path))
    gw = SqlGateway(s)
    gw.submit("c0", HERD_SQL)
    gw.submit("c1", HERD_SQL)
    gw.run()
    assert s.metrics.tree()["timeseries"]["enabled"] is True
    payload = gw.stats_payload()
    ts_section = payload["timeseries"]
    assert ts_section["enabled"] is True and ts_section["drains"] >= 1
    key = s.template_key(HERD_SQL)
    tmpl = ts_section["templates"][key]
    assert tmpl["deliveries"] == 2
    assert tmpl["latency_s"]["window"] == 2
    assert tmpl["latency_s"]["p95"] > 0
    assert tmpl["sql"] == HERD_SQL
    json.dumps(payload)
    text = gw.metrics_text()
    for line in text.splitlines():
        assert line.startswith("#") or len(line.split()) == 2, line
    assert "timeseries_enabled 1" in text
    assert f"timeseries_templates_{key}_deliveries 2" in text
    s.close()


def test_slo_breach_round_trip(catalogs, tmp_path):
    """An impossible target: breach counter, flight-recorder event and a
    slo_report() row; the generous one does not breach."""
    targets = (SloTarget(p95_latency_s=1e-9), SloTarget(max_fallback_rate=0.99))
    s = Session(catalogs[1], seed=5, device="cpu",
                config=_telemetry_cfg(SessionConfig, tmp_path, slo_targets=targets))
    gw = SqlGateway(s)
    gw.submit("c0", HERD_SQL)
    gw.run()
    assert s.metrics.counter("pilotdb_slo_breaches_total").value >= 1
    assert s.metrics.counter("pilotdb_slo_evaluations_total").value >= 2
    rows = gw.slo_report()
    breached = [r for r in rows if r["breached"]]
    assert breached and breached[0]["metric"] == "p95_latency_s"
    assert breached[0]["observed"] > breached[0]["target"]
    assert breached[0]["breaches_total"] >= 1
    ok = [r for r in rows if r["metric"] == "max_fallback_rate"]
    assert ok and not ok[0]["breached"]
    assert s.slo.summary()["enabled"] and s.slo.summary()["recent_breaches"]
    s.close()
    events = list(replay(str(tmp_path / "events.jsonl")))
    assert any(e["ev"] == "slo_breach" and e["metric"] == "p95_latency_s"
               for e in events)
    assert SqlGateway(Session(catalogs[1], seed=5, device="cpu")).slo_report() == []


def test_dashboard_renders_self_contained_html(catalogs, tmp_path):
    """tests/test_obs.py's dashboard case on the port, and the reference's
    renderer beside it on an equal session: the same sections."""
    (tmp_path / "ref").mkdir()
    (tmp_path / "port").mkdir()
    rs = ref_api.Session(catalogs[0], seed=5, config=_telemetry_cfg(
        ref_api.SessionConfig, tmp_path / "ref", trace_sample=1.0,
        slo_targets=(RefSloTarget(p95_latency_s=1e-9),)))
    s = Session(catalogs[1], seed=5, device="cpu", config=_telemetry_cfg(
        SessionConfig, tmp_path / "port", trace_sample=1.0,
        slo_targets=(SloTarget(p95_latency_s=1e-9),)))
    pages = []
    for session, render in ((rs, ref_render_dashboard), (s, render_dashboard)):
        session.submit(HERD_SQL)
        session.submit(HERD_SQL)
        session.drain()
        pages.append(render(session, title="test run"))
    html_doc = pages[1]
    assert html_doc.startswith("<!doctype html>")
    assert "test run" in html_doc
    assert s.template_key(HERD_SQL) in html_doc       # template table row
    assert "BREACHED" in html_doc
    assert "<svg" in html_doc
    assert "pilotdb_slo_breaches_total" in html_doc
    assert "http://" not in html_doc and "https://" not in html_doc
    headings = lambda doc: [p.split("</h2>")[0] for p in doc.split("<h2>")[1:]]
    assert headings(html_doc) == headings(pages[0])
    out = write_dashboard(str(tmp_path / "dash.html"), s)
    assert out is not None
    assert (tmp_path / "dash.html").read_text(encoding="utf-8").startswith("<!doctype html>")
    assert write_dashboard("/nonexistent-dir-for-pilotdb-tests/d.html", s) is None
    plain = Session(catalogs[1], seed=5, device="cpu")
    assert "Telemetry is off" in render_dashboard(plain)
    for x in (plain, s, rs):
        x.close()


def test_dashboard_has_one_row_per_template(catalogs):
    s = Session(catalogs[1], seed=5, device="cpu",
                config=SessionConfig(async_workers=0, result_cache_size=0, telemetry=True))
    gw = SqlGateway(s)
    sqls = [HERD_SQL, DASH_SQL.replace("10%", "12%"),
            "SELECT SUM(l_quantity) AS q FROM lineitem ERROR 10% CONFIDENCE 90%"]
    for i, sql in enumerate(sqls):
        gw.submit(f"c{i}", sql)
    gw.run()
    doc = render_dashboard(s)
    keys = {s.template_key(q) for q in sqls}
    table = doc.split("<h2>Per-template time-series</h2>")[1].split("<h2>")[0]
    assert table.count("<tr><td class='k'>") == len(keys) == len(
        gw.stats_payload()["timeseries"]["templates"])
    s.close()
