"""The port's engine (expressions, physical layer, executor) against the
reference's on the same data, on the CPU.

The reference runs with ``kernel_mode="pallas"`` (its kernels in interpret
mode), the route the port takes on every device; tables stay at a few
hundred blocks so interpret mode stays quick.
"""

import numpy as np
import pytest
import torch

import repro.engine.expr as r_expr
import repro.engine.logical as r_L
import repro.engine.physical as r_physical
import repro_torch.engine.expr as t_expr
import repro_torch.engine.logical as t_L
import repro_torch.engine.physical as t_physical
from repro.engine import Executor as RefExecutor
from repro.engine.datagen import tpch_catalog as ref_tpch_catalog
from repro_torch.engine.executor import EmptySampleError, Executor
from repro_torch.kernels.block_agg import block_agg
from repro_torch.kernels.filtered_agg import filtered_agg
from torch_parity import port_catalog

ROWS, BLOCK_ROWS = 20_000, 32   # 625 blocks


@pytest.fixture(scope="module")
def catalogs():
    ref = ref_tpch_catalog(ROWS, BLOCK_ROWS, seed=3)
    return ref, port_catalog(ref, "cpu")


def _exprs(E):
    """Predicates and channels of the slice, with and without Param slots."""
    ship, disc, price = E.Col("l_shipdate"), E.Col("l_discount"), E.Col("l_extendedprice")
    return [
        E.Between(ship, 100.0, 1500.0),
        E.Between(disc, E.Param(0), E.Param(1)),
        E.And(E.Cmp(">=", disc, E.Param(0)), E.Cmp("<", ship, E.Param(2))),
        E.Or(E.Cmp("<=", price, E.Param(3)), E.Not(E.Cmp("==", disc, E.Param(1)))),
        E.BinOp("*", price, disc),
        E.BinOp("-", E.BinOp("*", price, E.Param(1)), ship),
        E.BinOp("/", ship, E.Param(2)),
    ]


def test_eval_expr_matches_reference(catalogs):
    import jax.numpy as jnp
    ref, port = catalogs
    params = np.asarray([0.02, 0.08, 1500.0, 1000.0], np.float32)
    r_cols = ref["lineitem"].columns
    t_cols = port["lineitem"].columns
    for re, te in zip(_exprs(r_expr), _exprs(t_expr)):
        assert repr(re) == repr(te)
        a = np.asarray(r_expr.eval_expr(re, r_cols, jnp.asarray(params)))
        b = t_expr.eval_expr(te, t_cols, torch.from_numpy(params)).numpy()
        assert a.dtype == b.dtype, (re, a.dtype, b.dtype)
        np.testing.assert_array_equal(a, b)


def _q6(L, E, sample=None, lo=0.02, hi=0.08):
    scan = L.Scan("lineitem", sample)
    pred = E.And(E.Between(E.Col("l_shipdate"), 100.0, 1500.0),
                 E.Between(E.Col("l_discount"), lo, hi))
    aggs = (L.AggSpec("sum", E.BinOp("*", E.Col("l_extendedprice"),
                                     E.Col("l_discount")), "revenue"),
            L.AggSpec("count", None, "n"))
    return L.Aggregate(L.Filter(scan, pred), aggs)


def _plain(L, E, sample=None):
    aggs = (L.AggSpec("sum", E.Col("l_extendedprice"), "s"),
            L.AggSpec("count", None, "n"),
            L.AggSpec("avg", E.Col("l_quantity"), "q"))
    return L.Aggregate(L.Scan("lineitem", sample), aggs)


def _count_only(L, E, sample=None):
    pred = E.Cmp("<", E.Col("l_quantity"), E.Const(24.0))
    return L.Aggregate(L.Filter(L.Scan("lineitem", sample), pred),
                       (L.AggSpec("count", None, "n"),))


SHAPES = {"q6": (_q6, "filtered_agg"), "plain": (_plain, "block_agg"),
          "count_only": (_count_only, "filtered_agg")}


def test_signature_slots_match_reference():
    rp, tp = _q6(r_L, r_expr), _q6(t_L, t_expr)
    assert repr(r_physical.plan_signature(rp)) == repr(t_physical.plan_signature(tp))
    assert np.array_equal(r_physical.plan_constants(rp), t_physical.plan_constants(tp))
    rt, tt = r_physical.plan_template(rp), t_physical.plan_template(tp)
    r_preds = r_physical._single_table_chain(rt.child, "lineitem")
    t_preds = t_physical._single_table_chain(tt.child, "lineitem")
    assert repr(r_physical._match_q6_bounds(r_preds)) == repr(t_physical._match_q6_bounds(t_preds))
    # a constant-varied plan shares the template, not the constants
    tp2 = _q6(t_L, t_expr, lo=0.03)
    assert t_physical.plan_signature(tp2) == t_physical.plan_signature(tp)
    assert not np.array_equal(t_physical.plan_constants(tp2), t_physical.plan_constants(tp))


@pytest.mark.parametrize("shape", sorted(SHAPES))
@pytest.mark.parametrize("rate,seed", [(0.1, 5), (0.3, 6)])
def test_execute_matches_reference(catalogs, shape, rate, seed):
    ref, port = catalogs
    build, route = SHAPES[shape]
    rex = RefExecutor(ref, kernel_mode="pallas")
    tex = Executor(port, device="cpu")
    rres = rex.execute(build(r_L, r_expr, r_L.SampleClause("block", rate, seed)))
    calls = (filtered_agg.calls, block_agg.calls)
    tres = tex.execute(build(t_L, t_expr, t_L.SampleClause("block", rate, seed)))
    moved = (filtered_agg.calls - calls[0], block_agg.calls - calls[1])
    assert moved[0 if route == "filtered_agg" else 1] > 0
    ri, ti = rres.sample_infos["lineitem"], tres.sample_infos["lineitem"]
    assert np.array_equal(ri.sampled_block_ids, ti.sampled_block_ids)
    assert ri.n_sampled_blocks == ti.n_sampled_blocks
    assert rres.scanned_bytes == tres.scanned_bytes
    np.testing.assert_array_equal(rres.group_counts, tres.group_counts)
    np.testing.assert_allclose(tres.raw_sums, rres.raw_sums, rtol=1e-5)
    np.testing.assert_allclose(tres.values, rres.values, rtol=1e-5)


@pytest.mark.parametrize("shape", sorted(SHAPES))
def test_exact_execute_matches_reference(catalogs, shape):
    ref, port = catalogs
    build, _ = SHAPES[shape]
    rres = RefExecutor(ref, kernel_mode="pallas").execute(build(r_L, r_expr))
    tex = Executor(port, device="cpu")
    tres = tex.execute(build(t_L, t_expr))
    assert rres.scanned_bytes == tres.scanned_bytes
    np.testing.assert_array_equal(rres.group_counts, tres.group_counts)
    np.testing.assert_allclose(tres.values, rres.values, rtol=1e-5)
    compiled = tex.physical.compile_query(build(t_L, t_expr), tex._scan_runtimes(
        build(t_L, t_expr))[0])
    assert compiled.route == "torch_scan"


@pytest.mark.parametrize("shape", sorted(SHAPES))
@pytest.mark.parametrize("theta,seed", [(0.05, 1), (0.2, 2)])
def test_execute_pilot_matches_reference(catalogs, shape, theta, seed):
    ref, port = catalogs
    build, route = SHAPES[shape]
    rst = RefExecutor(ref, kernel_mode="pallas").execute_pilot(
        build(r_L, r_expr), "lineitem", theta, seed)
    tex = Executor(port, device="cpu")
    tst = tex.execute_pilot(build(t_L, t_expr), "lineitem", theta, seed)
    assert tst.n_sampled_blocks == rst.n_sampled_blocks
    assert tst.agg_names == rst.agg_names
    assert tst.block_sums.shape == rst.block_sums.shape
    assert tst.scanned_bytes == rst.scanned_bytes
    np.testing.assert_array_equal(tst.group_present, rst.group_present)
    np.testing.assert_allclose(tst.block_sums, rst.block_sums, rtol=1e-5)
    assert tex.physical._cache  # one compiled pilot, on the kernel route
    assert next(iter(tex.physical._cache.values())).route == route


def test_signature_cache_serves_constant_variants(catalogs):
    _, port = catalogs
    tex = Executor(port, device="cpu")
    for lo in (0.02, 0.03, 0.04):
        tex.execute(_q6(t_L, t_expr, t_L.SampleClause("block", 0.1, 9), lo=lo))
    info = tex.compile_cache_info()
    assert (info.misses, info.hits, info.size) == (1, 2, 1)


def test_empty_sample_raises(catalogs):
    _, port = catalogs
    tex = Executor(port, device="cpu")
    with pytest.raises(EmptySampleError):
        tex.execute(_plain(t_L, t_expr, t_L.SampleClause("block", 1e-9, 1)))


@pytest.mark.parametrize("what", ["group_by", "join", "row_sample", "or_filter"])
def test_shapes_of_later_slices_raise(catalogs, what):
    """The four shapes an earlier slice refused (GROUP BY, a join, row
    sampling, an OR predicate) no longer raise: they run through the gather
    route and equal the reference's ``xla_gather`` route — block ids and row
    counts exactly, sums to rtol 1e-5 (``tests/test_torch_gather.py`` holds
    the route to the reference shape by shape)."""
    ref, port = catalogs
    tex = Executor(port, device="cpu")
    rex = RefExecutor(ref, kernel_mode="xla")

    def plan(L, E):
        aggs = (L.AggSpec("count", None, "n"),
                L.AggSpec("sum", E.Col("l_extendedprice"), "s"))
        block = L.SampleClause("block", 0.1, 1)
        if what == "group_by":
            return L.Aggregate(L.Scan("lineitem", block), aggs, "l_returnflag", 3)
        if what == "join":
            return L.Aggregate(L.Join(L.Scan("lineitem", block), L.Scan("orders"),
                                      "l_orderkey", "o_orderkey"), aggs)
        if what == "row_sample":
            return L.Aggregate(L.Scan("lineitem", L.SampleClause("row", 0.1, 1)), aggs)
        pred = E.Or(E.Cmp("<", E.Col("l_quantity"), E.Const(5.0)),
                    E.Cmp(">", E.Col("l_quantity"), E.Const(40.0)))
        return L.Aggregate(L.Filter(L.Scan("lineitem", block), pred), aggs)

    r = rex.execute(plan(r_L, r_expr))
    t = tex.execute(plan(t_L, t_expr))
    for name, ri in r.sample_infos.items():
        ti = t.sample_infos[name]
        assert (ti.method, ti.n_sampled_blocks, ti.n_sampled_rows) == \
            (ri.method, ri.n_sampled_blocks, ri.n_sampled_rows)
        if ri.sampled_block_ids is not None:
            np.testing.assert_array_equal(ti.sampled_block_ids, ri.sampled_block_ids)
    np.testing.assert_array_equal(t.group_counts, r.group_counts)
    np.testing.assert_allclose(t.values, r.values, rtol=1e-5)
    assert t.scanned_bytes == r.scanned_bytes
