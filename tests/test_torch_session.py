"""``Session.sql`` end to end: the port against the reference, same seed.

Both sessions see the same 200k-row ``tpch_catalog(block_rows=32)`` (the
port's copy made through ``repro_torch.convert``) and the same SQL; the
reference runs under its ``pallas`` (interpret mode) and ``xla`` configs.
Seeds, pilot draws, final block ids and the fallback decision must be
equal; rates agree to rtol 1e-6 (the f64 host solve is fed f32 block sums
whose last bit may differ) and answers to rtol 1e-5.
"""

import numpy as np
import pytest

import repro.api as ref_api
from repro.engine.datagen import tpch_catalog as ref_tpch_catalog
from repro_torch.api import Session
from repro_torch.kernels.block_agg import block_agg
from repro_torch.kernels.filtered_agg import filtered_agg
from torch_parity import Q6, SUM_COUNT, port_catalog

QUERIES = {
    "q6_approx": Q6 + " ERROR 10% CONFIDENCE 95%",
    "q6_exact": Q6,
    "sum_count_approx": SUM_COUNT + " ERROR 5% CONFIDENCE 95%",
    "sum_count_exact": SUM_COUNT,
}


@pytest.fixture(scope="module")
def catalogs():
    ref = ref_tpch_catalog(200_000, 32, seed=0)
    return ref, port_catalog(ref, "cpu")


def _spy(session):
    """Record the pilot draws (theta, seed) and final block ids a session's
    executor is asked for."""
    seen = {"pilots": [], "final_ids": []}
    ex = session.executor
    execute, execute_pilot = ex.execute, ex.execute_pilot

    def spy_pilot(plan, table, theta_p, seed, pair_tables=()):
        seen["pilots"].append((table, theta_p, seed))
        return execute_pilot(plan, table, theta_p, seed, pair_tables=pair_tables)

    def spy_execute(plan):
        res = execute(plan)
        seen["final_ids"].append({t: i.sampled_block_ids
                                  for t, i in res.sample_infos.items()})
        return res

    ex.execute_pilot, ex.execute = spy_pilot, spy_execute
    return seen


def _counters():
    return (filtered_agg.calls, block_agg.calls,
            filtered_agg.launches, block_agg.launches)


@pytest.fixture(scope="module")
def port_runs(catalogs):
    _, port = catalogs
    out = {}
    for name, sql in QUERIES.items():
        s = Session(port, seed=42, device="cpu")
        seen = _spy(s)
        before = _counters()
        h = s.sql(sql)
        moved = tuple(b - a for a, b in zip(before, _counters()))
        out[name] = (s, h, seen, moved)
    return out


@pytest.mark.parametrize("kernel_mode", ["pallas", "xla"])
@pytest.mark.parametrize("name", sorted(QUERIES))
def test_session_sql_matches_reference(catalogs, port_runs, kernel_mode, name):
    ref, _ = catalogs
    rs = ref_api.Session(ref, seed=42,
                         config=ref_api.SessionConfig(kernel_mode=kernel_mode))
    r_seen = _spy(rs)
    rh = rs.sql(QUERIES[name])
    s, h, seen, _ = port_runs[name]
    assert (h.status, h.error) == ("done", None)
    assert rh.status == "done"
    # content-derived seeds: the same blake2b over the same dataclass reprs
    assert h.seed == rh.seed
    assert s._pilot_seed_for(h) == rs._pilot_seed_for(rh)
    assert h.fallback == rh.fallback
    rep, rrep = h.report, rh.report
    assert seen["pilots"] == r_seen["pilots"]
    assert rep.n_pilot_blocks == rrep.n_pilot_blocks
    assert rep.pilot_scanned_bytes == rrep.pilot_scanned_bytes
    assert rep.exact_scanned_bytes == rrep.exact_scanned_bytes
    assert len(seen["final_ids"]) == len(r_seen["final_ids"])
    for a, b in zip(seen["final_ids"], r_seen["final_ids"]):
        assert a.keys() == b.keys()
        for t in a:
            assert np.array_equal(a[t], b[t])
    assert (rep.plan is None) == (rrep.plan is None)
    if rep.plan is not None:
        assert rep.plan.rates.keys() == rrep.plan.rates.keys()
        for t, r in rep.plan.rates.items():
            assert r == pytest.approx(rrep.plan.rates[t], rel=1e-6)
        assert rep.final_scanned_bytes == rrep.final_scanned_bytes
    assert h.answer.names == rh.answer.names
    np.testing.assert_array_equal(h.answer.group_present, rh.answer.group_present)
    np.testing.assert_allclose(h.answer.values, rh.answer.values, rtol=1e-5)


def test_approximate_queries_take_the_sampled_kernel_routes(port_runs):
    """The guarantee path really sampled (no fallback) and went through the
    kernel wrappers: filtered_agg for Q6, block_agg for SUM/COUNT.  On the
    CPU the wrappers ran their plain versions, so ``calls`` moved and no
    CUDA launch was counted."""
    for name, route in (("q6_approx", 0), ("sum_count_approx", 1)):
        s, h, _, moved = port_runs[name]
        assert h.fallback is None and h.report.plan is not None
        assert moved[route] >= 2          # pilot and final
        assert moved[2:] == (0, 0)        # CPU tensors: no CUDA launch
        assert s.executor.pilots_run == 1 and s.executor.queries_run == 1
        r = h.report
        assert r.pilot_scanned_bytes + r.final_scanned_bytes < r.exact_scanned_bytes
    for name in ("q6_exact", "sum_count_exact"):
        _, h, seen, moved = port_runs[name]
        assert h.fallback == "requested exact" and moved == (0, 0, 0, 0)
        assert not seen["pilots"]


def test_guarantee_holds_against_the_exact_answer(port_runs):
    for approx, exact in (("q6_approx", "q6_exact"),
                          ("sum_count_approx", "sum_count_exact")):
        a, e = port_runs[approx][1].answer.values, port_runs[exact][1].answer.values
        assert np.all(np.abs(a - e) <= 0.10 * np.abs(e))


def test_execution_failures_are_captured_on_the_handle(catalogs):
    """An error raised while a query executes fails its handle, with the
    error's type and message, as the reference's does: here a self join
    whose right side brings a column the left side already has."""
    ref, port = catalogs
    sql = ("SELECT SUM(l_quantity) AS q FROM lineitem "
           "JOIN lineitem ON l_orderkey = l_orderkey")
    for text in (sql, sql + " ERROR 5% CONFIDENCE 95%"):
        h = Session(port, seed=1, device="cpu").sql(text)
        rh = ref_api.Session(ref, seed=1).sql(text)
        assert h.status == rh.status == "failed"
        assert h.error == rh.error == \
            "ValueError: column name collision in join: l_quantity"


def test_exact_sums_against_f64(catalogs, port_runs):
    """The port's exact SUM (a tree-order ``torch.sum`` in f32) stays within
    1e-6 of an f64 sum of the same data, and no farther from it than the
    reference's f32 scatter-add — the reason exact answers are compared
    with the reference at rtol 1e-5 and not tighter."""
    ref, _ = catalogs
    price = np.asarray(ref["lineitem"].columns["l_extendedprice"], np.float64)
    truth = price.sum()
    port = port_runs["sum_count_exact"][1].answer.values[0, 0]
    rs = ref_api.Session(ref, seed=42)
    reference = rs.sql(QUERIES["sum_count_exact"]).answer.values[0, 0]
    assert abs(port - truth) <= 1e-6 * truth
    assert abs(port - truth) <= abs(reference - truth)


def test_dictionary_literals_and_having_match_reference(catalogs):
    """String literals lower through a registered dictionary, and HAVING
    filters the delivered answer, as in the reference (exact route)."""
    ref, port = catalogs
    sql = ("SELECT COUNT(*) AS n, SUM(l_quantity) AS q FROM lineitem "
           "WHERE l_returnflag = 'R' AND l_shipdate < 1000 HAVING n > 10")
    s = Session(port, seed=7, device="cpu")
    rs = ref_api.Session(ref, seed=7)
    for sess in (s, rs):
        sess.register_dictionary("l_returnflag", ["A", "N", "R"])
    h, rh = s.sql(sql), rs.sql(sql)
    assert (h.status, h.error) == ("done", None) and rh.status == "done"
    assert h.seed == rh.seed
    np.testing.assert_array_equal(h.answer.group_present, rh.answer.group_present)
    np.testing.assert_allclose(h.answer.values, rh.answer.values, rtol=1e-5)
