"""The client-API remnants of the port against the reference, on the CPU:
the result cache's byte budget, ``Session.failed_handle``,
``SessionConfig.batch_finals`` and ``resolve_pilot_workers``, and the
runtime's ``in_flight`` / ``totals`` / ``wait_idle`` with the scheduler's
``total_drained``.

The reference's ``tests/test_runtime.py`` cases run here by name against
the port, on the reference tests' own catalog, ``tpch_catalog(scale_rows=
200_000, block_rows=32, seed=0)``, built by both packages from the same
numpy seed (the port's with ``device="cpu"``).  ``failed_handle`` has no
reference case of its own (the reference's gateway calls it); a new case
holds the port's handle to the reference's.  Where a case compares two
runs, ``result_cache_info().bytes_used`` equals the reference's exactly.

The pilot-worker default departs from the reference on purpose: the
port's ``pilot_workers`` is 0 (serial pilot stages; ROADMAP queue 1 item 3
decides it), where the reference auto-sizes; ``None`` auto-sizes in both.
"""

import dataclasses as dc
import functools
import os

import numpy as np
import pytest

import repro.api as ref_api
from repro.engine.datagen import tpch_catalog as ref_tpch_catalog
from repro_torch.api import QueryStatus, SessionConfig
from repro_torch.api import Session as _Session
from repro_torch.core.taqa import ApproxAnswer, TaqaReport
from repro_torch.engine.datagen import tpch_catalog
from repro_torch.kernels.filtered_agg import filtered_agg, filtered_agg_batched
from repro_torch.runtime import CachedAnswer, ResultCache

Session = functools.partial(_Session, device="cpu")

HERD_SQL = ("SELECT SUM(l_extendedprice * l_discount) AS rev FROM lineitem "
            "WHERE l_quantity < 24 ERROR 8% CONFIDENCE 95%")
NOCACHE_CFG = SessionConfig(async_workers=4, result_cache_size=0)
BUDGET_SQLS = [f"SELECT COUNT(*) AS n FROM lineitem WHERE l_shipdate < {c}"
               for c in (500, 1000, 1500, 2000)]


@pytest.fixture(scope="module")
def catalogs():
    return (ref_tpch_catalog(scale_rows=200_000, block_rows=32, seed=0),
            tpch_catalog(scale_rows=200_000, block_rows=32, seed=0,
                         device="cpu"))


@pytest.fixture(scope="module")
def catalog(catalogs):
    return catalogs[1]


# ---------------------------------------------------------------------------
# The result cache's byte budget
# ---------------------------------------------------------------------------

def _entry(n_groups):
    ans = ApproxAnswer(names=["a"], values=np.zeros((1, n_groups)),
                       group_present=np.ones(n_groups, bool),
                       report=TaqaReport())
    return CachedAnswer.from_answer(ans)


def test_result_cache_byte_budget_evicts_lru_first():
    small = _entry(8)
    # budget fits two small entries but not three
    cache = ResultCache(capacity=100, max_bytes=2 * small.nbytes() + 10)
    cache.put("a", _entry(8), ("t",))
    cache.put("b", _entry(8), ("t",))
    assert cache.get("a") is not None     # refresh: "b" becomes LRU
    cache.put("c", _entry(8), ("t",))      # over budget: evicts "b"
    assert cache.get("b") is None
    assert cache.get("a") is not None and cache.get("c") is not None
    info = cache.info()
    assert info.evictions == 1 and info.bytes_used <= info.max_bytes
    # an entry larger than the whole budget is never admitted
    cache.put("huge", _entry(100_000), ("t",))
    assert cache.get("huge") is None


def test_cached_answer_nbytes_is_the_references():
    from repro.runtime import CachedAnswer as RefCachedAnswer
    from repro.core.taqa import ApproxAnswer as RefApproxAnswer
    from repro.core.taqa import TaqaReport as RefTaqaReport
    for n in (1, 8, 91):
        ref = RefCachedAnswer.from_answer(RefApproxAnswer(
            names=["a"], values=np.zeros((1, n)),
            group_present=np.ones(n, bool), report=RefTaqaReport()))
        assert _entry(n).nbytes() == ref.nbytes()


def test_session_result_cache_byte_budget(catalogs):
    ref_cat, catalog = catalogs
    session = Session(catalog, seed=3, config=SessionConfig(
        result_cache_size=64, result_cache_bytes=2_000))
    for s in BUDGET_SQLS:
        session.sql(s)
    info = session.result_cache_info()
    assert info.max_bytes == 2_000
    assert info.bytes_used <= 2_000
    assert info.size < len(BUDGET_SQLS)  # the budget, not capacity, bounded it
    session.close()

    ref = ref_api.Session(ref_cat, seed=3, config=ref_api.SessionConfig(
        result_cache_size=64, result_cache_bytes=2_000))
    for s in BUDGET_SQLS:
        ref.sql(s)
    r_info = ref.result_cache_info()
    assert (info.bytes_used, info.size, info.evictions) == \
        (r_info.bytes_used, r_info.size, r_info.evictions)
    ref.close()


@pytest.mark.parametrize("sql", [HERD_SQL, BUDGET_SQLS[0]])
def test_session_bytes_used_equal_the_references(catalogs, sql):
    """An approximate entry (values + the advisory pilot summary) and an
    exact one (no summary) charge the reference's bytes exactly."""
    ref_cat, catalog = catalogs
    s = Session(catalog, seed=13)
    s.sql(sql)
    ref = ref_api.Session(ref_cat, seed=13)
    ref.sql(sql)
    assert s.result_cache_info().bytes_used == \
        ref.result_cache_info().bytes_used > 0
    s.close()
    ref.close()


# ---------------------------------------------------------------------------
# failed_handle
# ---------------------------------------------------------------------------

def test_failed_handle_matches_reference(catalogs):
    ref_cat, catalog = catalogs
    error = "SqlSyntaxError: unexpected token 'SELEKT'"
    out = []
    for make, cat in ((Session, catalog), (ref_api.Session, ref_cat)):
        s = make(cat, seed=3)
        before = s.prepare(HERD_SQL)
        h = s.failed_handle("SELEKT 1", error)
        after = s.prepare(HERD_SQL)
        assert h.done and h.wait(0) and h.status == QueryStatus.FAILED
        with pytest.raises(RuntimeError, match="SqlSyntaxError"):
            h.result()
        out.append((before.query_id, h.query_id, after.query_id, h.status,
                    h.error, h.sql, h.query, h.spec, h.seed, h.answer))
        # a pre-failed handle never enters the queue
        assert s.scheduler.submit(h) is h
        assert s.scheduler.pending_count == 0
        s.close()
    assert out[0] == out[1]
    assert out[0][:3] == (0, 1, 2)  # the next query id advances


# ---------------------------------------------------------------------------
# batch_finals, pilot workers, the runtime's counters
# ---------------------------------------------------------------------------

def test_batching_respects_runtime_feature_toggles(catalog):
    """batch_finals=False keeps per-member final launches (the pilots
    stack either way); answers stay bitwise equal either way."""
    sqls = [("SELECT SUM(l_extendedprice * l_discount) AS rev FROM lineitem "
             f"WHERE l_quantity < {c} ERROR 10% CONFIDENCE 90%")
            for c in (18, 24, 30)]
    cfg = SessionConfig(async_workers=0, result_cache_size=0)
    on = Session(catalog, seed=4, config=cfg)
    off = Session(catalog, seed=4, config=dc.replace(cfg, batch_finals=False))
    h_on = [on.submit(s) for s in sqls]
    h_off = [off.submit(s) for s in sqls]
    b0, f0 = filtered_agg_batched.calls, filtered_agg.calls
    on.drain()
    b1, f1 = filtered_agg_batched.calls, filtered_agg.calls
    off.drain()
    b2, f2 = filtered_agg_batched.calls, filtered_agg.calls
    assert b1 - b0 == 2          # one stacked pilot, one batched launch of finals
    assert f1 - f0 < len(sqls)   # no solo pilot; a final alone in its bucket
    assert b2 - b1 == 1          # batch_finals=False: the stacked pilot only,
    assert f2 - f1 == len(sqls)  # and a solo final per member
    for a, b in zip(h_on, h_off):
        assert a.status == b.status == "done"
        assert np.array_equal(a.result().values, b.result().values)
    on.close(), off.close()


def test_drain_stats_report_resolved_pool_widths(catalog):
    for cfg in (SessionConfig(async_workers=3, pilot_workers=2,
                              result_cache_size=0),
                SessionConfig(async_workers=None, pilot_workers=None,
                              result_cache_size=0),
                SessionConfig(async_workers=None, result_cache_size=0)):
        session = Session(catalog, seed=2, config=cfg)
        session.submit("SELECT COUNT(*) AS n FROM orders")
        session.drain()
        stats = session.scheduler.last_drain
        assert stats.workers == session.runtime.workers \
            == cfg.resolve_workers()
        assert stats.pilot_workers == session.runtime.pilot_workers \
            == cfg.resolve_pilot_workers()
        session.close()


def test_resolve_pilot_workers_matches_reference():
    # None auto-sizes exactly as the reference does; an explicit width is
    # taken as is; the port's default is 0
    for knob in (None, 0, 1, 3):
        assert SessionConfig(pilot_workers=knob).resolve_pilot_workers() == \
            ref_api.SessionConfig(pilot_workers=knob).resolve_pilot_workers()
    cpus = os.cpu_count() or 1
    assert SessionConfig(pilot_workers=None).resolve_pilot_workers() == \
        (0 if cpus <= 1 else min(4, cpus))
    assert SessionConfig().resolve_pilot_workers() == 0


def test_drain_stats_reset_per_drain(catalog):
    session = Session(catalog, seed=5, config=NOCACHE_CFG)
    session.submit(HERD_SQL)
    session.submit(HERD_SQL)
    session.drain()
    first = session.scheduler.last_drain
    assert first.n_queries == 2 and first.pilots_run == 1
    session.submit(HERD_SQL)
    session.drain()
    second = session.scheduler.last_drain
    assert second is not first
    assert second.n_queries == 1 and second.pilots_run == 1
    assert first.n_queries == 2
    # cumulative totals accumulate elsewhere
    assert session.scheduler.total_drained == 3
    assert session.metrics.counter("pilotdb_drains_total").value == 2
    assert session.metrics.counter(
        "pilotdb_drained_queries_total").value == 3
    totals = session.runtime.totals()
    assert totals["groups_total"] == 2 and totals["in_flight"] == 0
    assert totals["workers"] == 4
    session.close()


def test_drain_async_poll_wait(catalog):
    session = Session(catalog, seed=6, config=NOCACHE_CFG)
    h = session.submit(HERD_SQL)
    assert h.poll() == "pending"
    dispatched = session.drain_async()  # returns without blocking
    assert [x.query_id for x in dispatched] == [h.query_id]
    assert session.scheduler.pending_count == 0
    assert h.wait(timeout=120), "query did not finish in time"
    assert h.poll() == "done" and h.scalar("rev") > 0
    assert session.runtime.wait_idle(timeout=120)
    assert session.runtime.in_flight == 0
    assert session.scheduler.total_drained == 1
    session.close()


def test_runtime_in_flight_tracks_dispatch(catalog):
    session = Session(catalog, seed=0, config=NOCACHE_CFG)
    assert session.runtime.in_flight == 0
    handles = [session.submit(HERD_SQL) for _ in range(2)]
    session.drain_async()
    assert session.runtime.wait_idle(timeout=120)
    assert session.runtime.in_flight == 0
    assert all(h.status == "done" for h in handles)
    session.close()
