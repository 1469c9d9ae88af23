"""The port's host-side modules against the reference's on equal inputs.

These modules are copies (numpy / pure Python) with imports rewired, so the
results must be equal — bit for bit, not within a tolerance: the rate solve,
the sampling decisions, the data and the cost model all feed seeds, block
ids and fallback decisions that the port must reproduce exactly.
"""

import dataclasses
import math

import numpy as np
import pytest
import torch

import repro.core.allocation as r_alloc
import repro.core.bsap as r_bsap
import repro.core.planner as r_planner
import repro.core.propagation as r_prop
import repro.engine.cost as r_cost
import repro.engine.datagen as r_datagen
import repro.engine.logical as r_L
import repro.engine.physical as r_physical
import repro.engine.sampling as r_sampling
import repro.stats.distributions as r_dist
import repro_torch.core.allocation as t_alloc
import repro_torch.core.bsap as t_bsap
import repro_torch.core.planner as t_planner
import repro_torch.core.propagation as t_prop
import repro_torch.engine.cost as t_cost
import repro_torch.engine.datagen as t_datagen
import repro_torch.engine.logical as t_L
import repro_torch.engine.physical as t_physical
import repro_torch.engine.sampling as t_sampling
import repro_torch.stats.distributions as t_dist
from repro.engine.expr import Between as r_Between, Col as r_Col
from repro_torch.engine.expr import Between as t_Between, Col as t_Col


@pytest.mark.parametrize("p", [1e-6, 0.0125, 0.5, 0.975, 0.999999])
@pytest.mark.parametrize("df", [1, 5, 29, 43, 1000])
def test_distributions_equal(p, df):
    assert t_dist.normal_ppf(p) == r_dist.normal_ppf(p)
    assert t_dist.student_t_ppf(p, df) == r_dist.student_t_ppf(p, df)
    assert t_dist.chi2_ppf(p, df) == r_dist.chi2_ppf(p, df)
    assert (t_dist.binomial_lower_bound(50_000 + df, 0.01, p)
            == r_dist.binomial_lower_bound(50_000 + df, 0.01, p))
    assert (t_dist.population_lower_bound(40 + df, 0.007, p)
            == r_dist.population_lower_bound(40 + df, 0.007, p))
    # the fallbacks used where scipy is absent are copies too
    assert t_dist._acklam(p) == r_dist._acklam(p)


def _pilot_sums(seed, n_p=44, n_right=16):
    rng = np.random.default_rng(seed)
    y = rng.gamma(2.0, 1e5, n_p)
    pair = rng.gamma(2.0, 1e3, (n_p, n_right))
    return y, pair


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_bsap_bounds_equal(seed):
    y, pair = _pilot_sums(seed)
    for d in (0.001, 0.0125):
        assert t_bsap.block_mean_lower(y, d) == r_bsap.block_mean_lower(y, d)
        for side in ("upper", "lower"):
            assert (t_bsap.t_bound_sum(y, 6250, d, side)
                    == r_bsap.t_bound_sum(y, 6250, d, side))
        for nb in (6250, None):
            u_t = t_bsap.single_table_var_ub(y, 0.0072, d, n_blocks=nb)
            u_r = r_bsap.single_table_var_ub(y, 0.0072, d, n_blocks=nb)
            for theta in (1e-4, 0.02, 0.0826, 1.0):
                assert u_t(theta) == u_r(theta)
        j_t = t_bsap.join_var_ub(pair, 6250, d)
        j_r = r_bsap.join_var_ub(pair, 6250, d)
        for t1, t2 in ((0.01, 0.5), (0.1, 0.1), (0.05, 0.99)):
            assert j_t(t1, t2) == j_r(t1, t2)
    assert (t_bsap.group_coverage_rate(6250, 32, 200, 0.05)
            == r_bsap.group_coverage_rate(6250, 32, 200, 0.05))
    assert t_bsap.z_for(0.98) == r_bsap.z_for(0.98)
    assert (t_bsap.efficiency_ratio(y, 32) == r_bsap.efficiency_ratio(y, 32))


@pytest.mark.parametrize("kind", ["sum", "count", "avg", "ratio", "product", "add"])
def test_allocation_and_propagation_equal(kind):
    for n in (1, 2, 7):
        assert (dataclasses.astuple(t_alloc.allocate(0.95, n, 0.05))
                == dataclasses.astuple(r_alloc.allocate(0.95, n, 0.05)))
    assert t_prop.split_budget(kind, 0.05) == r_prop.split_budget(kind, 0.05)
    assert t_prop.propagate_division(0.01, 0.02) == r_prop.propagate_division(0.01, 0.02)
    assert t_prop.propagate_product(0.01, 0.02) == r_prop.propagate_product(0.01, 0.02)


@pytest.mark.parametrize("seed", [0, 3])
def test_planner_solves_the_same_rates(seed):
    y, _ = _pilot_sums(seed)
    plans = []
    for bsap, planner in ((r_bsap, r_planner), (t_bsap, t_planner)):
        b = (r_alloc if planner is r_planner else t_alloc).allocate(0.95, 2, 0.05)
        L_mu = 6250 * bsap.block_mean_lower(y, b.delta1)
        uv = bsap.single_table_var_ub(y, 0.0072, b.delta2, n_blocks=6250)
        c = planner.Constraint(label="c", z=bsap.z_for(b.p_prime), L_mu=L_mu,
                               error=0.05,
                               var_fn=lambda r, uv=uv: uv(r.get("t", 1.0)))
        cands = planner.solve_candidates([c, c], ["t"], max_rate=0.1)
        chosen = planner.pick_plan(cands, cost_fn=lambda r: r["t"] * 1e6,
                                   exact_cost=1e6)
        plans.append((len(cands), None if chosen is None else chosen.rates))
    assert plans[0] == plans[1]


@pytest.mark.parametrize("clustered", [False, True])
def test_datagen_bytes_identical(clustered):
    ref = r_datagen.tpch_catalog(3000, 32, clustered=clustered, seed=5)
    port = t_datagen.tpch_catalog(3000, 32, clustered=clustered, seed=5,
                                  device="cpu")
    assert ref.keys() == port.keys()
    for name in ref:
        r, t = ref[name], port[name]
        assert (r.block_rows, r.num_rows, r.num_origin_blocks) == \
            (t.block_rows, t.num_rows, t.num_origin_blocks)
        assert list(r.columns) == list(t.columns)
        for c in r.columns:
            a, b = np.asarray(r.columns[c]), t.columns[c].numpy()
            assert a.dtype == b.dtype and a.tobytes() == b.tobytes()
        assert np.asarray(r.valid).tobytes() == t.valid.numpy().tobytes()
        assert np.asarray(r.block_id).tobytes() == t.block_id.numpy().tobytes()
        assert r.row_bytes() == t.row_bytes() and r.total_bytes() == t.total_bytes()
    rs = r_datagen.make_skewed(2000, 64, seed=9)
    ts = t_datagen.make_skewed(2000, 64, seed=9, device="cpu")
    for c in rs.columns:
        assert np.asarray(rs.columns[c]).tobytes() == ts.columns[c].numpy().tobytes()


@pytest.mark.parametrize("num_blocks,rate,seed", [
    (6250, 0.0072, 11), (6250, 0.0826, 12), (100, 0.5, 13), (1_000, 1e-5, 14)])
def test_block_draws_identical(num_blocks, rate, seed):
    a = r_sampling.draw_block_ids(num_blocks, rate, seed)
    b = t_sampling.draw_block_ids(num_blocks, rate, seed)
    assert a.dtype == b.dtype and np.array_equal(a, b)
    pa, pb = r_sampling.pad_block_ids(a, num_blocks), t_sampling.pad_block_ids(b, num_blocks)
    assert np.array_equal(pa[0], pb[0]) and pa[1:] == pb[1:]
    for k in (0, 1, 64, 65, 937, 4096):
        assert r_sampling.bucket_blocks(k) == t_sampling.bucket_blocks(k)


def _plans(L, Col, Between, sample):
    scan = L.Scan("lineitem", sample)
    filt = L.Filter(scan, Between(Col("l_shipdate"), 100.0, 1500.0))
    aggs = (L.AggSpec("sum", Col("l_extendedprice"), "ch0"),
            L.AggSpec("count", None, "ch1"))
    return [L.Aggregate(scan, aggs), L.Aggregate(filt, aggs)]


def test_cost_model_and_plan_rewrites_equal():
    ref = r_datagen.tpch_catalog(3000, 32, seed=1)
    port = t_datagen.tpch_catalog(3000, 32, seed=1, device="cpu")
    for sample in (None, ("block", 0.05, 7)):
        rp = _plans(r_L, r_Col, r_Between,
                    None if sample is None else r_L.SampleClause(*sample))
        tp = _plans(t_L, t_Col, t_Between,
                    None if sample is None else t_L.SampleClause(*sample))
        for a, b in zip(rp, tp):
            assert repr(a) == repr(b)
            assert r_cost.exact_cost(a, ref) == t_cost.exact_cost(b, port)
            for rates in ({}, {"lineitem": 0.0826}):
                assert r_cost.plan_cost(a, ref, rates) == t_cost.plan_cost(b, port, rates)
            assert repr(r_L.extract_constants(a)) == repr(t_L.extract_constants(b))
            assert repr(r_L.strip_samples(a)) == repr(t_L.strip_samples(b))
    for method, n in (("block", 17), ("none", 0)):
        assert (r_physical.scan_cost_bytes(ref["lineitem"], method, n)
                == t_physical.scan_cost_bytes(port["lineitem"], method, n))


def test_table_geometry_from_numpy():
    cols = {"a": np.arange(70, dtype=np.float32), "b": np.arange(70, dtype=np.int32)}
    t = t_datagen.BlockTable.from_numpy("t", cols, 32, device="cpu")
    assert t.padded_rows == 96 and t.num_blocks == 3 and t.num_rows == 70
    assert t.valid.dtype == torch.bool and int(t.valid.sum()) == 70
    assert t.block_id.tolist() == np.repeat(np.arange(3), 32).tolist()
    assert math.isclose(t.total_bytes(), 96 * 8)
