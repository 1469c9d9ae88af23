"""The Quickr row-sampling baseline (§5.4, Fig. 12) of the port against the
reference's, on the CPU.

Both packages build ``tpch_catalog(600_000, 32, seed=0)`` from one numpy
seed; the reference runs its ``xla`` route.  Row draws are the reference's
bit for bit (one uniform per padded row), so the kept row counts, the
fallbacks and the scanned bytes must be equal; the row rate, solved in f64
from f32 pilot sums, within rtol 1e-6; answers within rtol 1e-5 (the f32
sums of the gather route, reduced in another order).  The cases are the
reference's ``test_row_baseline_guarantee_and_cost`` and
``test_block_beats_row_scan_bytes``, plus a grouped and a COUNT query.
"""

import numpy as np
import pytest

import repro.engine.expr as r_expr
import repro.engine.logical as r_L
from repro.core import CompositeAgg as RefCompositeAgg
from repro.core import ErrorSpec as RefErrorSpec
from repro.core import PilotDB as RefPilotDB
from repro.core import Query as RefQuery
from repro.core import RowSamplingAQP as RefRowSamplingAQP
from repro.engine.datagen import tpch_catalog as ref_tpch_catalog
from repro.engine.executor import Executor as RefExecutor
import repro_torch.engine.expr as t_expr
import repro_torch.engine.logical as t_L
from repro_torch.core import CompositeAgg, ErrorSpec, PilotDB, Query, RowSamplingAQP
from repro_torch.engine.datagen import tpch_catalog
from repro_torch.engine.executor import Executor
from repro_torch.kernels.segment_sum import segment_sum

SPEC = dict(error=0.10, confidence=0.9)


@pytest.fixture(scope="module")
def dbs():
    ref = ref_tpch_catalog(scale_rows=600_000, block_rows=32, seed=0)
    cat = tpch_catalog(scale_rows=600_000, block_rows=32, seed=0, device="cpu")
    return (RefExecutor(ref), Executor(cat, device="cpu"))


def q6(L, E, Q, C):
    pred = E.And(E.Col("l_shipdate").between(100, 1500),
                 E.And(E.Col("l_discount").between(0.02, 0.08),
                       E.Col("l_quantity") < 24))
    return Q(child=L.Filter(L.Scan("lineitem"), pred),
             aggs=(C("revenue", "sum", E.Col("l_extendedprice") * E.Col("l_discount")),))


def grouped(L, E, Q, C):
    return Q(child=L.Filter(L.Scan("lineitem"), E.Col("l_shipdate") < 2000),
             aggs=(C("qty", "sum", E.Col("l_quantity")),),
             group_by="l_returnflag", max_groups=3)


def counted(L, E, Q, C):
    return Q(child=L.Filter(L.Scan("lineitem"), E.Col("l_discount") > 0.03),
             aggs=(C("n", "count", None), C("avg_qty", "avg", E.Col("l_quantity"))))


SHAPES = {"q6": q6, "grouped": grouped, "count_avg": counted}


def both(dbs, shape, seed, cls=("row", "row")):
    ex_r, ex_t = dbs
    ref_cls = RefRowSamplingAQP if cls[0] == "row" else RefPilotDB
    port_cls = RowSamplingAQP if cls[1] == "row" else PilotDB
    a_r = ref_cls(ex_r, large_table_rows=50_000).query(
        SHAPES[shape](r_L, r_expr, RefQuery, RefCompositeAgg), RefErrorSpec(**SPEC),
        seed=seed)
    a_t = port_cls(ex_t, large_table_rows=50_000).query(
        SHAPES[shape](t_L, t_expr, Query, CompositeAgg), ErrorSpec(**SPEC), seed=seed)
    return a_r, a_t


def assert_same(a_r, a_t):
    rr, rt = a_r.report, a_t.report
    assert rr.fallback == rt.fallback
    assert rr.n_pilot_blocks == rt.n_pilot_blocks   # kept pilot rows
    assert rr.theta_pilot == rt.theta_pilot
    assert (rr.plan is None) == (rt.plan is None)
    if rr.plan is not None:
        for table, rate in rr.plan.rates.items():
            assert rt.plan.rates[table] == pytest.approx(rate, rel=1e-6)
    assert rr.pilot_scanned_bytes == rt.pilot_scanned_bytes
    assert rr.final_scanned_bytes == rt.final_scanned_bytes
    assert rr.exact_scanned_bytes == rt.exact_scanned_bytes
    np.testing.assert_array_equal(a_r.group_present, a_t.group_present)
    np.testing.assert_allclose(a_t.values, a_r.values, rtol=1e-5)


@pytest.mark.parametrize("seed", [11, 12])
def test_row_baseline_guarantee_and_cost(dbs, seed):
    a_r, a_t = both(dbs, "q6", seed)
    assert_same(a_r, a_t)
    assert a_t.report.fallback is None
    exact = PilotDB(dbs[1], large_table_rows=50_000).exact(
        q6(t_L, t_expr, Query, CompositeAgg))
    rel = abs(a_t.scalar("revenue") - exact.scalar("revenue")) / abs(exact.scalar("revenue"))
    assert rel <= SPEC["error"]
    # row sampling cannot skip blocks: the final scan pays the full table
    assert a_t.report.final_scanned_bytes >= dbs[1].table_bytes("lineitem")


def test_block_beats_row_scan_bytes(dbs):
    a_blk_r, a_blk_t = both(dbs, "q6", 7, cls=("block", "block"))
    a_row_r, a_row_t = both(dbs, "q6", 7)
    assert_same(a_blk_r, a_blk_t)
    assert_same(a_row_r, a_row_t)
    assert a_blk_t.report.final_scanned_bytes < a_row_t.report.final_scanned_bytes


@pytest.mark.parametrize("shape", ["grouped", "count_avg"])
def test_row_baseline_matches_the_reference(dbs, shape):
    a_r, a_t = both(dbs, shape, 3)
    assert_same(a_r, a_t)


def test_row_sampled_plans_take_the_gather_route(dbs):
    """Quickr's pilots and final are row-sampled plans: each runs as one
    segment_sum call over every row of the table."""
    ex = dbs[1]
    calls, queries = segment_sum.calls, ex.queries_run
    ans = RowSamplingAQP(ex, large_table_rows=50_000).query(
        q6(t_L, t_expr, Query, CompositeAgg), ErrorSpec(**SPEC), seed=5)
    assert ans.report.fallback is None
    assert ex.queries_run - queries == 3             # pilot, squared pilot, final
    assert segment_sum.calls - calls == 3
