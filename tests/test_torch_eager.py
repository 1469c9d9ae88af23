"""The port's eager executor (``Executor(use_compiled=False)``), its
relational operators (``engine/ops.py``) and the sampling-equivalence rules
(``core/equivalence.py``, Props. 4.4–4.6), on the CPU.

The eager executor is the in-package oracle.  Against the reference's eager
executor on ``tpch_catalog(200_000, 32, seed=0)`` (built by both packages
from one numpy seed): the same sampled block ids, kept rows, fallbacks and
scanned bytes; sums, answers and pilot statistics within rtol 1e-5 (f32
sums reduced in another order).  Against the port's compiled route: the
same draws and bytes, sums within rtol 1e-5.  The equivalence checks are
the reference's ``tests/test_equivalence.py``, run through the port's
operators, each side also held to the reference's side.
"""

import numpy as np
import pytest
import torch
from hypothesis import given, settings, strategies as st

import repro.core.equivalence as REQ
import repro.engine.expr as r_expr
import repro.engine.logical as r_L
from repro.core import CompositeAgg as RefCompositeAgg
from repro.core import ErrorSpec as RefErrorSpec
from repro.core import PilotDB as RefPilotDB
from repro.core import Query as RefQuery
from repro.engine.datagen import tpch_catalog as ref_tpch_catalog
from repro.engine.executor import Executor as RefExecutor
from repro.engine.table import BlockTable as RefBlockTable
import repro_torch.core.equivalence as EQ
import repro_torch.engine.expr as t_expr
import repro_torch.engine.logical as t_L
from repro_torch.core import CompositeAgg, ErrorSpec, PilotDB, Query
from repro_torch.engine import ops
from repro_torch.engine.datagen import tpch_catalog
from repro_torch.engine.executor import EmptySampleError, Executor
from repro_torch.engine.table import BlockTable
from repro_torch.kernels.segment_sum import segment_sum


@pytest.fixture(scope="module")
def catalogs():
    return (ref_tpch_catalog(200_000, 32, seed=0),
            tpch_catalog(200_000, 32, seed=0, device="cpu"))


def plans(L, E):
    q6 = E.And(E.Col("l_shipdate").between(100, 1500),
               E.Col("l_discount").between(0.02, 0.08))
    blk = lambda rate, seed=3: L.Scan("lineitem", L.SampleClause("block", rate, seed))
    row = L.Scan("lineitem", L.SampleClause("row", 0.05, 4))
    rev = E.Col("l_extendedprice") * E.Col("l_discount")
    return {
        "exact_q6": L.Aggregate(L.Filter(L.Scan("lineitem"), q6),
                                (L.AggSpec("sum", rev, "rev"),)),
        "block_q6": L.Aggregate(L.Filter(blk(0.1), q6),
                                (L.AggSpec("sum", rev, "rev"),
                                 L.AggSpec("count", None, "n"))),
        "block_grouped": L.Aggregate(
            L.Filter(blk(0.2), E.Col("l_shipdate") < 2000),
            (L.AggSpec("sum", E.Col("l_quantity"), "qty"),
             L.AggSpec("avg", E.Col("l_extendedprice"), "avg")),
            group_by="l_returnflag", max_groups=3),
        "row_sum": L.Aggregate(row, (L.AggSpec("sum", E.Col("l_extendedprice"), "s"),)),
        "join": L.Aggregate(
            L.Filter(L.Join(blk(0.1), L.Scan("orders"), "l_orderkey", "o_orderkey"),
                     E.Col("o_orderdate") < 1200),
            (L.AggSpec("sum", E.Col("l_extendedprice"), "rev"),)),
        # one sample clause on both inputs: the compiled route keys a scan's
        # draw by its table, so a table sampled two ways is not one plan
        "union": L.Aggregate(
            L.Union((L.Filter(blk(0.1, 5), E.Col("l_quantity") < 5),
                     L.Filter(blk(0.1, 5), E.Col("l_quantity") > 45))),
            (L.AggSpec("sum", E.Col("l_quantity"), "qty"),)),
    }


PLANS = list(plans(t_L, t_expr))


@pytest.mark.parametrize("name", PLANS)
def test_eager_matches_the_reference_and_the_compiled_route(catalogs, name):
    ref_cat, cat = catalogs
    r = RefExecutor(ref_cat, use_compiled=False).execute(plans(r_L, r_expr)[name])
    ex = Executor(cat, device="cpu", use_compiled=False)
    t = ex.execute(plans(t_L, t_expr)[name])
    c = Executor(cat, device="cpu").execute(plans(t_L, t_expr)[name])
    assert ex.device_dispatches == 0 and ex.compile_cache_info().misses == 0
    for other, rtol in ((r, 1e-5), (c, 1e-5)):
        assert t.agg_names == other.agg_names
        assert t.scanned_bytes == other.scanned_bytes
        assert set(t.sample_infos) == set(other.sample_infos)
        for tab, info in t.sample_infos.items():
            o = other.sample_infos[tab]
            assert (info.method, info.n_sampled_blocks, info.n_sampled_rows) == \
                (o.method, o.n_sampled_blocks, o.n_sampled_rows)
            if info.method == "block":
                np.testing.assert_array_equal(info.sampled_block_ids,
                                              o.sampled_block_ids)
        np.testing.assert_array_equal(t.group_counts, other.group_counts)
        np.testing.assert_allclose(t.raw_sums, other.raw_sums, rtol=rtol)
        np.testing.assert_allclose(t.values, other.values, rtol=rtol)


@pytest.mark.parametrize("pair", [False, True])
def test_eager_pilot_matches_the_reference(catalogs, pair):
    ref_cat, cat = catalogs

    def pilot_plan(L, E):
        child = L.Scan("lineitem")
        if pair:
            child = L.Join(child, L.Scan("orders"), "l_orderkey", "o_orderkey")
        return L.Aggregate(L.Filter(child, E.Col("l_quantity") < 30),
                           (L.AggSpec("sum", E.Col("l_extendedprice"), "s"),))

    pt = ("orders",) if pair else ()
    r = RefExecutor(ref_cat, use_compiled=False).execute_pilot(
        pilot_plan(r_L, r_expr), "lineitem", 0.05, 9, pair_tables=pt)
    t = Executor(cat, device="cpu", use_compiled=False).execute_pilot(
        pilot_plan(t_L, t_expr), "lineitem", 0.05, 9, pair_tables=pt)
    c = Executor(cat, device="cpu").execute_pilot(
        pilot_plan(t_L, t_expr), "lineitem", 0.05, 9, pair_tables=pt)
    for other in (r, c):
        assert t.n_sampled_blocks == other.n_sampled_blocks
        assert t.scanned_bytes == other.scanned_bytes
        assert t.agg_names == other.agg_names
        np.testing.assert_array_equal(t.group_present, other.group_present)
        np.testing.assert_allclose(t.block_sums, other.block_sums, rtol=1e-5)
        assert set(t.pair_sums) == set(other.pair_sums) == set(pt)
        for k in pt:
            np.testing.assert_allclose(t.pair_sums[k], other.pair_sums[k], rtol=1e-5)


def q6(L, E, Q, C):
    pred = E.And(E.Col("l_shipdate").between(100, 1500),
                 E.And(E.Col("l_discount").between(0.02, 0.08), E.Col("l_quantity") < 24))
    return Q(child=L.Filter(L.Scan("lineitem"), pred),
             aggs=(C("revenue", "sum", E.Col("l_extendedprice") * E.Col("l_discount")),))


def q1(L, E, Q, C):
    return Q(child=L.Filter(L.Scan("lineitem"), E.Col("l_shipdate") < 2400),
             aggs=(C("qty", "sum", E.Col("l_quantity")),
                   C("avg_price", "avg", E.Col("l_extendedprice"))),
             group_by="l_returnflag", max_groups=3)


@pytest.mark.parametrize("shape", [q6, q1], ids=["q6", "q1"])
def test_taqa_over_the_eager_executor(catalogs, shape):
    """PilotDB over the eager oracle: the reference's eager answers, and the
    port's compiled answers (same pilot draw, same plan, same final draw)."""
    ref_cat, cat = catalogs
    spec = dict(error=0.1, confidence=0.95)
    a_r = RefPilotDB(RefExecutor(ref_cat, use_compiled=False)).query(
        shape(r_L, r_expr, RefQuery, RefCompositeAgg), RefErrorSpec(**spec), seed=2)
    ex = Executor(cat, device="cpu", use_compiled=False)
    a_t = PilotDB(ex).query(shape(t_L, t_expr, Query, CompositeAgg),
                            ErrorSpec(**spec), seed=2)
    a_c = PilotDB(Executor(cat, device="cpu")).query(
        shape(t_L, t_expr, Query, CompositeAgg), ErrorSpec(**spec), seed=2)
    assert ex.device_dispatches == 0
    for other in (a_r, a_c):
        assert a_t.report.fallback == other.report.fallback
        assert a_t.report.n_pilot_blocks == other.report.n_pilot_blocks
        assert (a_t.report.plan is None) == (other.report.plan is None)
        if a_t.report.plan is not None:
            for tab, rate in a_t.report.plan.rates.items():
                assert other.report.plan.rates[tab] == pytest.approx(rate, rel=1e-6)
        assert a_t.report.final_scanned_bytes == other.report.final_scanned_bytes
        np.testing.assert_allclose(a_t.values, other.values, rtol=1e-5)


def test_eager_executor_stages_nothing_and_batches_nothing(catalogs):
    _, cat = catalogs
    ex = Executor(cat, device="cpu", use_compiled=False)
    ex.register_staged("lineitem", [0.1])
    assert ex.staged.ladder("lineitem") is None
    with pytest.raises(KeyError):
        ex.register_staged("nope")
    ps = plans(t_L, t_expr)
    out = ex.execute_batch([ps["block_q6"], ps["block_q6"], ps["block_grouped"]])
    assert ex.queries_run == 3 and ex.device_dispatches == 0
    solo = [ex.execute(p) for p in (ps["block_q6"], ps["block_grouped"])]
    np.testing.assert_array_equal(out[0].values, solo[0].values)
    np.testing.assert_array_equal(out[1].values, solo[0].values)
    np.testing.assert_array_equal(out[2].values, solo[1].values)
    empty = t_L.Aggregate(t_L.Scan("lineitem", t_L.SampleClause("block", 1e-9, 1)),
                          (t_L.AggSpec("count", None, "n"),))
    assert isinstance(ex.execute_batch([empty, ps["block_q6"]])[0], EmptySampleError)
    with pytest.raises(EmptySampleError):
        ex.execute(empty)


def test_group_reductions_go_through_segment_sum(catalogs):
    _, cat = catalogs
    li = cat["lineitem"]
    calls = segment_sum.calls
    sums = ops.grouped_sums(li, [t_expr.Col("l_quantity"), None], "l_returnflag", 3)
    assert segment_sum.calls - calls == 1
    counts = sums[1]
    g = li.columns["l_returnflag"].numpy()[li.valid.numpy()]
    q = li.columns["l_quantity"].numpy()[li.valid.numpy()].astype(np.float64)
    for k in range(3):
        assert counts[k].item() == (g == k).sum()
        assert sums[0, k].item() == pytest.approx(q[g == k].sum(), rel=1e-5)


# -- the sampling-equivalence rules (Props. 4.4–4.6) ---------------------------

def _arrays(rows, br, seed, key_mod=None):
    rng = np.random.default_rng(seed)
    return {
        "k": (np.arange(rows) % (key_mod or max(rows // 2, 1))).astype(np.int32),
        "x": rng.normal(5.0, 2.0, rows).astype(np.float32),
        "g": rng.integers(0, 3, rows).astype(np.int32),
    }


def _tables(rows, br, seed, name="t", key_mod=None):
    cols = _arrays(rows, br, seed, key_mod)
    return (RefBlockTable.from_numpy(name, cols, br),
            BlockTable.from_numpy(name, cols, br, device="cpu"))


def _rows_equal(a, b):
    assert a["cols"] == b["cols"]
    np.testing.assert_allclose(a["rows"], b["rows"], rtol=1e-5, atol=1e-5)


def _keep(bits, n):
    return np.array([i for i in range(n) if (bits >> i) & 1], dtype=np.int32)


@settings(max_examples=25, deadline=None)
@given(seed=st.integers(0, 1000), thresh=st.floats(2.0, 8.0), bits=st.integers(1, 63))
def test_selection_commutes(seed, thresh, bits):
    rt, t = _tables(48, 8, seed)  # 6 blocks
    keep = _keep(bits, 6)
    a = EQ.surviving_rows(EQ.sample_then_filter(t, keep, t_expr.Col("x") > thresh))
    b = EQ.surviving_rows(EQ.filter_then_sample(t, keep, t_expr.Col("x") > thresh))
    _rows_equal(a, b)
    _rows_equal(a, REQ.surviving_rows(REQ.sample_then_filter(rt, keep, r_expr.Col("x") > thresh)))


@settings(max_examples=25, deadline=None)
@given(seed=st.integers(0, 1000), bits=st.integers(1, 63))
def test_join_commutes(seed, bits):
    rng = np.random.default_rng(seed)
    rleft, left = _tables(48, 8, seed, "l", key_mod=12)
    rcols = {"pk": np.arange(12, dtype=np.int32),
             "w": rng.normal(size=12).astype(np.float32)}
    rright = RefBlockTable.from_numpy("r", rcols, 4)
    right = BlockTable.from_numpy("r", rcols, 4, device="cpu")
    keep = _keep(bits, 6)
    a = EQ.surviving_rows(EQ.sample_then_join(left, keep, right, "k", "pk"))
    b = EQ.surviving_rows(EQ.join_then_sample(left, keep, right, "k", "pk"))
    _rows_equal(a, b)
    _rows_equal(a, REQ.surviving_rows(REQ.sample_then_join(rleft, keep, rright, "k", "pk")))


@settings(max_examples=20, deadline=None)
@given(seed=st.integers(0, 1000), bits1=st.integers(0, 15), bits2=st.integers(0, 15))
def test_union_commutes(seed, bits1, bits2):
    r1, t1 = _tables(32, 8, seed, "a")
    r2, t2 = _tables(32, 8, seed + 1, "b")
    k1, k2 = _keep(bits1, 4), _keep(bits2, 4)
    if len(k1) + len(k2) == 0:
        return
    a = EQ.surviving_rows(EQ.sample_then_union([t1, t2], [k1, k2]))
    b = EQ.surviving_rows(EQ.union_then_sample([t1, t2], [k1, k2]))
    _rows_equal(a, b)
    _rows_equal(a, REQ.surviving_rows(REQ.union_then_sample([r1, r2], [k1, k2])))


def test_prop_4_3_aggregate_distribution_exhaustive():
    """Prop. 4.3's consequence: SUM over the pre- and post-sampled pipelines
    has the same distribution — exactly, by enumerating all kept sets."""
    _, t = _tables(40, 8, seed=9)  # 5 blocks
    pred = t_expr.Col("x") > 5.0
    dist_a, dist_b = {}, {}
    for bits in range(1, 1 << 5):
        keep = _keep(bits, 5)
        sa = EQ.sample_then_filter(t, keep, pred)
        sb = EQ.filter_then_sample(t, keep, pred)
        for table, dist in ((sa, dist_a), (sb, dist_b)):
            v = round(float(EQ.surviving_columns(table)["x"].sum()), 3)
            dist[v] = dist.get(v, 0) + 1  # uniform over kept sets
    assert dist_a == dist_b


def test_normalize_accepts_scan_level_samples():
    plan = t_L.Aggregate(child=t_L.Scan("t", t_L.SampleClause("block", 0.1)),
                         aggs=(t_L.AggSpec("sum", t_expr.Col("x"), "s"),))
    assert EQ.normalize(plan) is plan
