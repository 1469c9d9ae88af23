"""``Session.submit`` + ``drain`` end to end: the port against the reference
and against itself, on the CPU.

The herd (a dashboard-like mix on ``tpch_catalog(200_000, 32, seed=0)``,
session seed 21): six Q6-shaped members differing only in a ``l_quantity``
constant, the c = 24 member again at ``ERROR 5%`` (the reference falls back
to exact there), and SUM/COUNT at ERROR 5/6/7/8 %, whose pilot the last
three share.  Drained on ``async_workers=0, result_cache_size=0``, the port
must match the reference's drain under both its ``pallas`` (interpret mode)
and ``xla`` configs: equal fallbacks, pilot sharing, pilot sizes and final
block ids; rates within rtol 1e-6 (the f64 host solve is fed f32 block sums
whose last bit may differ) and answers within rtol 1e-5.
"""

import numpy as np
import pytest

import repro.api as ref_api
from repro.engine.datagen import tpch_catalog as ref_tpch_catalog
from repro_torch.api import Session, SessionConfig
from repro_torch.engine.datagen import tpch_catalog
from repro_torch.kernels.block_agg import block_agg, block_agg_batched
from repro_torch.kernels.filtered_agg import filtered_agg, filtered_agg_batched
from torch_parity import port_catalog

Q6 = ("SELECT SUM(l_extendedprice * l_discount) AS rev FROM lineitem "
      "WHERE l_quantity < {c} ERROR {e}% CONFIDENCE 95%")
SC = ("SELECT SUM(l_extendedprice) AS s, COUNT(*) AS n FROM lineitem "
      "ERROR {e}% CONFIDENCE 95%")
HERD = ([Q6.format(c=c, e=8) for c in (18, 21, 24, 27, 30, 33)]
        + [Q6.format(c=24, e=5)] + [SC.format(e=e) for e in (5, 6, 7, 8)])
SEED = 21
SERIAL = dict(async_workers=0, result_cache_size=0)


@pytest.fixture(scope="module")
def catalogs():
    ref = ref_tpch_catalog(200_000, 32, seed=0)
    return ref, port_catalog(ref, "cpu")


def _spy_finals(session):
    """Record the sampled final block ids each drain's finals drew, in
    dispatch order (batched and solo finals alike)."""
    seen = []
    ex = session.executor
    execute_batch = ex.execute_batch

    def spy(plans, on_result=None):
        results = execute_batch(plans, on_result=on_result)
        for r in results:
            if hasattr(r, "sample_infos"):
                seen.append({t: i.sampled_block_ids
                             for t, i in r.sample_infos.items()})
        return results

    ex.execute_batch = spy
    return seen


def _drain(session, herd=HERD):
    hs = [session.submit(q) for q in herd]
    session.drain()
    return hs


def _counters():
    return (filtered_agg.calls, block_agg.calls, filtered_agg_batched.calls,
            block_agg_batched.calls)


@pytest.fixture(scope="module")
def port_drain(catalogs):
    _, port = catalogs
    s = Session(port, seed=SEED, device="cpu", config=SessionConfig(**SERIAL))
    seen = _spy_finals(s)
    before = _counters()
    hs = _drain(s)
    moved = tuple(b - a for a, b in zip(before, _counters()))
    yield s, hs, seen, moved
    s.close()


@pytest.mark.parametrize("kernel_mode", ["pallas", "xla"])
def test_drain_matches_reference(catalogs, port_drain, kernel_mode):
    ref, _ = catalogs
    rs = ref_api.Session(ref, seed=SEED, config=ref_api.SessionConfig(
        kernel_mode=kernel_mode, **SERIAL))
    try:
        r_seen = _spy_finals(rs)
        rhs = _drain(rs)
        s, hs, seen, _ = port_drain
        st, rst = s.scheduler.last_drain, rs.scheduler.last_drain
        assert (st.pilots_run, rst.pilots_run) == (7, 7)
        assert (st.n_groups, st.group_sizes) == (rst.n_groups, rst.group_sizes)
        assert st.compile_misses == rst.compile_misses
        for h, rh in zip(hs, rhs):
            assert (h.status, h.error) == ("done", None) and rh.status == "done"
            assert h.seed == rh.seed
            assert s._pilot_seed_for(h) == rs._pilot_seed_for(rh)
            rep, rrep = h.report, rh.report
            assert h.fallback == rrep.fallback
            assert rep.pilot_shared == rrep.pilot_shared
            assert rep.n_pilot_blocks == rrep.n_pilot_blocks
            assert (rep.plan is None) == (rrep.plan is None)
            if rep.plan is not None:
                for t, r in rep.plan.rates.items():
                    assert r == pytest.approx(rrep.plan.rates[t], rel=1e-6)
                assert rep.final_scanned_bytes == rrep.final_scanned_bytes
            np.testing.assert_allclose(h.answer.values, rh.answer.values,
                                       rtol=1e-5)
        # the c = 24 / 5% member falls back to exact in both
        assert sum(h.fallback is not None for h in hs) == 1
        assert len(seen) == len(r_seen) > 0
        for a, b in zip(seen, r_seen):
            assert a.keys() == b.keys()
            for t in a:
                np.testing.assert_array_equal(a[t], b[t])
    finally:
        rs.close()


def test_drain_takes_the_batched_kernel_routes(port_drain):
    """Two Q6 buckets and one SUM/COUNT bucket each ran as one batched call,
    and the six Q6 pilots as one stacked call of the batched kernel; the
    SUM/COUNT pilot took the solo kernel; on the CPU nothing launched a CUDA
    kernel (the wrappers ran their plain versions)."""
    s, _, _, moved = port_drain
    fa, ba, fab, bab = moved
    assert (fab, bab) == (3, 1)          # two Q6 final buckets + the Q6 pilots
    assert fa == 2 and ba >= 1           # solo Q6 finals; the SUM/COUNT pilot
    routes = {c.route for c in s.executor.physical._cache.values()}
    assert {"filtered_agg_batched", "block_agg_batched", "filtered_agg",
            "block_agg", "torch_scan"} <= routes
    stacked = [c for k, c in s.executor.physical._cache.items()
               if k[0] == "pilot_batched"]
    assert [(c.route, c.batch) for c in stacked] == [("filtered_agg_batched", 6)]
    info = s.compile_cache_info()
    assert info.batched_misses == 3
    assert (filtered_agg_batched.launches, block_agg_batched.launches) == (0, 0)


def _values(handles):
    return [h.answer.values for h in handles]


def test_drain_is_bitwise_its_own_serial_session(catalogs, port_drain):
    """Shared pilots and batched finals change launches, never answers: the
    drain is bitwise an equal-seed serial session's ``sql``."""
    _, port = catalogs
    _, hs, _, _ = port_drain
    serial = Session(port, seed=SEED, device="cpu", config=SessionConfig(
        async_workers=0, share_pilots=False,
        result_cache_size=0))
    try:
        for h, q in zip(hs, HERD):
            r = serial.sql(q)
            assert r.status == "done"
            np.testing.assert_array_equal(h.answer.values, r.answer.values)
            assert h.fallback == r.fallback
            assert h.report.n_pilot_blocks == r.report.n_pilot_blocks
    finally:
        serial.close()


@pytest.mark.parametrize("workers", [(4, 0), (4, 4), (2, 2)])
def test_threaded_drain_is_bitwise_the_serial_drain(catalogs, port_drain, workers):
    """Group and pilot pools change wall-clock, never answers or the
    compile-miss count (a key builds once however many workers ask)."""
    _, port = catalogs
    s0, hs0, _, _ = port_drain
    s = Session(port, seed=SEED, device="cpu", config=SessionConfig(
        async_workers=workers[0], pilot_workers=workers[1],
        result_cache_size=0))
    try:
        hs = _drain(s)
        for a, b in zip(hs, hs0):
            assert a.status == "done"
            np.testing.assert_array_equal(a.answer.values, b.answer.values)
            assert a.report.pilot_shared == b.report.pilot_shared
        st, st0 = s.scheduler.last_drain, s0.scheduler.last_drain
        assert st.workers == workers[0]
        assert (st.pilots_run, st.compile_misses) == \
            (st0.pilots_run, st0.compile_misses)
    finally:
        s.close()


def test_a_second_drain_is_served_from_the_result_cache(catalogs):
    _, port = catalogs
    s = Session(port, seed=SEED, device="cpu",
                config=SessionConfig(async_workers=2))
    try:
        first = _drain(s)
        before, misses = _counters(), s.compile_cache_info().misses
        second = _drain(s)
        assert _counters() == before          # no kernel call at all
        st = s.scheduler.last_drain
        assert (st.result_hits, st.pilots_run, st.compile_misses) == \
            (len(HERD), 0, 0)
        assert s.compile_cache_info().misses == misses
        for a, b in zip(first, second):
            assert b.cached and not a.cached
            np.testing.assert_array_equal(a.answer.values, b.answer.values)
            assert a.report is b.report     # the guarantee computed once
        assert s.result_cache_info().hits == len(HERD)
        # Session.sql is served from the same cache
        h = s.sql(HERD[0])
        assert h.cached and np.array_equal(h.answer.values, first[0].answer.values)
    finally:
        s.close()


def test_register_table_between_submit_and_drain_answers_from_new_data():
    """A replacement that lands before the drain starts: the queued query
    runs on the new data (and the old answer is evicted from the cache)."""
    old = tpch_catalog(60_000, 32, seed=0, device="cpu")
    new = tpch_catalog(60_000, 32, seed=5, device="cpu")
    q = HERD[-1]
    s = Session(old, seed=SEED, device="cpu")
    fresh = Session(new, seed=SEED, device="cpu")
    try:
        first = s.sql(q)
        h = s.submit(q)
        s.register_table("lineitem", new["lineitem"])
        s.drain()
        want = fresh.sql(q)
        assert (h.status, h.error) == ("done", None) and not h.cached
        np.testing.assert_array_equal(h.answer.values, want.answer.values)
        assert not np.array_equal(h.answer.values, first.answer.values)
        assert s.result_cache_info().invalidations == 1
    finally:
        s.close()
        fresh.close()


def test_a_replacement_in_flight_fails_the_handle_retryably(catalogs):
    """An answer whose tables were replaced after it started is not a
    guarantee: the handle fails with a retryable error and nothing enters
    the cache."""
    _, port = catalogs
    s = Session(port, seed=SEED, device="cpu")
    try:
        h = s.prepare(HERD[0])
        gen = s._scan_generations(h.query)
        ans = s.db.query(h.query, h.spec, seed=h.seed,
                         pilot_seed=s._pilot_seed_for(h))
        s.register_table("lineitem", port["lineitem"])
        assert not s._complete_handle(h, ans, gen)
        assert h.status == "failed" and "resubmit" in h.error
        assert s.result_cache_info().size == 0
    finally:
        s.close()


def test_drain_async_and_the_queue_contract(catalogs):
    _, port = catalogs
    s = Session(port, seed=SEED, device="cpu",
                config=SessionConfig(async_workers=2, result_cache_size=0))
    try:
        hs = [s.submit(q) for q in HERD[:3]]
        assert s.submit.__self__.scheduler.submit(hs[0]) is hs[0]  # idempotent
        assert s.scheduler.pending_count == 3
        assert hs[0].poll() == "pending"
        with pytest.raises(RuntimeError, match="drain"):
            hs[0].result()
        out = s.drain_async()
        assert [h.query_id for h in out] == [h.query_id for h in hs]
        assert all(h.wait(timeout=120) for h in hs)
        assert all(h.poll() == "done" for h in hs)
        # max_queries bounds one drain; the rest stays queued
        more = [s.submit(q) for q in HERD[7:10]]
        assert len(s.drain(max_queries=2)) == 2
        assert s.scheduler.pending_count == 1
        s.drain()
        assert all(h.status == "done" for h in more)
    finally:
        s.close()


def test_groups_follow_the_template_signature(catalogs):
    _, port = catalogs
    s = Session(port, seed=SEED, device="cpu")
    try:
        a, b, c = (s.prepare(q) for q in (HERD[0], HERD[1], HERD[7]))
        assert a.group_key == b.group_key != c.group_key
        assert a.signature != b.signature
    finally:
        s.close()
