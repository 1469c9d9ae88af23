"""Stacked pilots (``PilotDB.run_pilots_batched`` →
``Executor.execute_pilots_batched`` → ``PhysicalCompiler.compile_batched_pilot``)
against the reference and against the port's own solo pilots, on the CPU.

Both packages see ``tpch_catalog(200_000, 32, seed=0)``, the port's copy made
through ``repro_torch.convert``.  The reference stacks on its XLA route (its
default on the CPU).  Against it the port's stacked pilots must give equal
draws, pilot sizes, rates, fallbacks and scanned bytes, block sums within
``tests/test_kernels.py``'s tolerances (rtol 1e-4 for ``filtered_agg``, 1e-5
for ``block_agg``), and equal dispatch, pilot-stage and compile-cache
counts.  Inside the port each lane is bitwise its member's solo
``run_pilot``: on the kernel route (one ``filtered_agg_batched`` /
``block_agg_batched`` call per channel column) and on the gather route (one
``segment_sum`` call under the slab claim, lane keys offset).
"""

import numpy as np
import pytest
import torch

import repro.api as ref_api
import repro.core.spec as r_spec
import repro.core.taqa as r_taqa
import repro.engine.expr as r_expr
import repro.engine.logical as r_L
from repro.engine.datagen import tpch_catalog as ref_tpch_catalog
from repro.engine.executor import Executor as RefExecutor
import repro_torch.core.spec as t_spec
import repro_torch.core.taqa as t_taqa
import repro_torch.engine.expr as t_expr
import repro_torch.engine.logical as t_L
from repro_torch.api import Session, SessionConfig
from repro_torch.dist import DistExecutor
from repro_torch.engine import physical
from repro_torch.engine.datagen import make_lineitem
from repro_torch.engine.executor import Executor
from repro_torch.kernels.block_agg import block_agg, block_agg_batched
from repro_torch.kernels.filtered_agg import filtered_agg, filtered_agg_batched
from repro_torch.kernels.segment_sum import segment_sum
from torch_parity import port_catalog

SPEC = dict(error=0.08, confidence=0.95)
GUARANTEE = " ERROR 15% CONFIDENCE 90%"


@pytest.fixture(scope="module")
def catalogs():
    ref = ref_tpch_catalog(200_000, 32, seed=0)
    return ref, port_catalog(ref, "cpu")


def _q6(taqa, spec, L, E, i):
    """The reference's ``test_batched_pilots_bitwise_match_solo`` member i."""
    pred = E.And(E.Col("l_shipdate").between(100, 1500 + 40 * i),
                 E.And(E.Col("l_discount").between(0.02, 0.08),
                       E.Col("l_quantity") < 24))
    return taqa.Query(child=L.Filter(L.Scan("lineitem"), pred),
                      aggs=(spec.CompositeAgg("revenue", "sum",
                                              E.Col("l_extendedprice") * E.Col("l_discount")),))


def _sum_count(taqa, spec, L, E, i):
    return taqa.Query(child=L.Scan("lineitem"),
                      aggs=(spec.CompositeAgg("s", "sum", E.Col("l_extendedprice")),
                            spec.CompositeAgg("n", "count", None)))


def _reqs(shape, taqa, spec, L, E):
    make = _q6 if shape == "q6" else _sum_count
    return [(make(taqa, spec, L, E, i), spec.ErrorSpec(**SPEC), 1000 + i)
            for i in range(3)]


def _spy_stacks(ex):
    """Record each stacked call's (thetas, block ids per lane)."""
    seen = []
    run = ex.execute_pilots_batched

    def spy(plans, table, thetas, runtimes_list):
        seen.append((list(thetas), [np.asarray(r[table].ids)[:r[table].n_real]
                                    for r in runtimes_list]))
        return run(plans, table, thetas, runtimes_list)

    ex.execute_pilots_batched = spy
    return seen


@pytest.mark.parametrize("shape,rtol", [("q6", 1e-4), ("sum_count", 1e-5)])
def test_stacked_pilots_match_the_reference(catalogs, shape, rtol):
    ref, port = catalogs
    rex, tex = RefExecutor(ref), Executor(port, device="cpu")
    rdb, tdb = r_taqa.PilotDB(rex, large_table_rows=50_000), \
        t_taqa.PilotDB(tex, large_table_rows=50_000)
    r_seen, t_seen = _spy_stacks(rex), _spy_stacks(tex)
    calls = (filtered_agg.calls, block_agg.calls, filtered_agg_batched.calls,
             block_agg_batched.calls)
    routs = rdb.run_pilots_batched(_reqs(shape, r_taqa, r_spec, r_L, r_expr))
    touts = tdb.run_pilots_batched(_reqs(shape, t_taqa, t_spec, t_L, t_expr))
    moved = tuple(b - a for a, b in zip(calls, (
        filtered_agg.calls, block_agg.calls, filtered_agg_batched.calls,
        block_agg_batched.calls)))
    # one stacked call in each package; no solo kernel call in the port
    assert tex.device_dispatches == rex.device_dispatches == 1
    assert tex.pilots_run == rex.pilots_run == 3
    assert moved == ((0, 0, 1, 0) if shape == "q6" else (0, 0, 0, 1))
    assert len(t_seen) == len(r_seen) == 1
    (tth, tids), (rth, rids) = t_seen[0], r_seen[0]
    assert tth == rth
    for a, b in zip(tids, rids):
        np.testing.assert_array_equal(a, b)
    for t, r in zip(touts, routs):
        assert not isinstance(t, Exception) and not isinstance(r, Exception)
        assert t.fallback == r.fallback is None
        assert t.report.n_pilot_blocks == r.report.n_pilot_blocks > 0
        assert t.report.theta_pilot == r.report.theta_pilot
        assert t.pilot.theta_p == r.pilot.theta_p
        assert t.report.pilot_scanned_bytes == r.report.pilot_scanned_bytes
        np.testing.assert_array_equal(t.pilot.group_present,
                                      np.asarray(r.pilot.group_present))
        np.testing.assert_allclose(t.pilot.block_sums,
                                   np.asarray(r.pilot.block_sums), rtol=rtol)
    # and each lane bitwise the port's own solo pilot
    solo = t_taqa.PilotDB(Executor(port, device="cpu"), large_table_rows=50_000)
    for (q, spec, pseed), t in zip(_reqs(shape, t_taqa, t_spec, t_L, t_expr), touts):
        alone = solo.run_pilot(q, spec, pseed)
        np.testing.assert_array_equal(t.pilot.block_sums, alone.pilot.block_sums)
        np.testing.assert_array_equal(t.pilot.group_present, alone.pilot.group_present)


def _lane_sqls(shape):
    if shape == "grouped":
        return [f"SELECT SUM(l_quantity) AS qty, AVG(l_extendedprice) AS p, "
                f"COUNT(*) AS n FROM lineitem WHERE l_shipdate < {x} "
                f"GROUP BY l_returnflag" + GUARANTEE for x in (1800, 2000, 2200, 2400)]
    return [f"SELECT SUM(l_quantity) AS q FROM lineitem JOIN orders ON "
            f"l_orderkey = o_orderkey WHERE l_shipdate < {x} "
            f"GROUP BY o_orderpriority" + GUARANTEE for x in (1500, 2000, 2500)]


@pytest.mark.parametrize("shape", ["grouped", "join_left"])
def test_gather_lanes_are_bitwise_their_solo_pilots(catalogs, shape):
    """A grouped Q1-like shape and a join with the pilot table on its left:
    one stacked call, ONE segment_sum call for every lane, each lane
    bitwise the member's own run_pilot."""
    _, port = catalogs
    ts = Session(port, seed=7, device="cpu", config=SessionConfig(result_cache_size=0))
    ex = ts.executor
    handles = [ts.prepare(sql) for sql in _lane_sqls(shape)]
    reqs = [(h.query, h.spec, 100 + i) for i, h in enumerate(handles)]
    d0, s0 = ex.device_dispatches, segment_sum.calls
    outs = ts.db.run_pilots_batched(reqs)
    assert (ex.device_dispatches - d0, segment_sum.calls - s0) == (1, 1)
    assert ex.pilots_run == len(reqs)
    routes = {c.route for k, c in ex.physical._cache.items() if k[0] == "pilot_batched"}
    assert routes == {"gather_stacked"}
    for (q, spec, pseed), out in zip(reqs, outs):
        assert not isinstance(out, Exception), out
        alone = ts.db.run_pilot(q, spec, pseed)
        assert out.fallback == alone.fallback
        assert out.pilot.n_sampled_blocks == alone.pilot.n_sampled_blocks > 0
        assert out.report.theta_pilot == alone.report.theta_pilot
        assert out.report.pilot_scanned_bytes == alone.report.pilot_scanned_bytes
        np.testing.assert_array_equal(out.pilot.block_sums, alone.pilot.block_sums)
        np.testing.assert_array_equal(out.pilot.group_present,
                                      alone.pilot.group_present)
    ts.close()


def _solo_case(port, case):
    """(executor, PilotDB, three queries) of a shape whose pilots stay solo."""
    if case == "union":
        cat = dict(port, lineitem_b=make_lineitem(64_000, 32, num_orders=50_000,
                                                  seed=5, device="cpu"))
        ex = Executor(cat, device="cpu")
        qs = [t_taqa.Query(
            child=t_L.Filter(t_L.Union((t_L.Scan("lineitem"), t_L.Scan("lineitem_b"))),
                             t_expr.Col("l_shipdate") < 1800 + 200 * i),
            aggs=(t_spec.CompositeAgg("s", "sum", t_expr.Col("l_extendedprice")),))
            for i in range(3)]
        # only lineitem is large: no pair table, the union alone keeps it solo
        return ex, t_taqa.PilotDB(ex, large_table_rows=100_000), qs
    if case == "sharded":
        ex = DistExecutor(port, device="cpu")
        ex.register_sharded("lineitem", port["lineitem"], 4)
    else:
        ex = Executor(port, device="cpu")
        if case == "staged":
            ex.register_staged("lineitem", (0.05, 0.2), seed=3)
    if case == "pair_join":
        qs = [t_taqa.Query(
            child=t_L.Filter(t_L.Join(t_L.Scan("lineitem"), t_L.Scan("orders"),
                                      "l_orderkey", "o_orderkey"),
                             t_expr.Col("o_orderdate") < 1000 + 200 * i),
            aggs=(t_spec.CompositeAgg("rev", "sum", t_expr.Col("l_extendedprice")),))
            for i in range(3)]
    else:
        qs = [_q6(t_taqa, t_spec, t_L, t_expr, i) for i in range(3)]
    return ex, t_taqa.PilotDB(ex, large_table_rows=50_000), qs


@pytest.mark.parametrize("case", ["pair_join", "staged", "sharded", "union"])
def test_shapes_that_do_not_stack_stay_solo(catalogs, case):
    _, port = catalogs
    ex, db, qs = _solo_case(port, case)
    stacked = _spy_stacks(ex)
    solo_pilots = []
    execute_pilot = ex.execute_pilot

    def spy(plan, table, theta_p, seed, pair_tables=()):
        solo_pilots.append(tuple(pair_tables))
        return execute_pilot(plan, table, theta_p, seed, pair_tables=pair_tables)

    ex.execute_pilot = spy
    reqs = [(q, t_spec.ErrorSpec(**SPEC), 50 + i) for i, q in enumerate(qs)]
    outs = db.run_pilots_batched(reqs)
    assert stacked == []
    assert len(solo_pilots) == ex.pilots_run == len(reqs)
    if case == "pair_join":
        assert set(solo_pilots) == {("orders",)}
    # the shard executor dispatches through its shards' compilers
    assert ex.device_dispatches == (0 if case == "sharded" else len(reqs))
    again = t_taqa.PilotDB(ex, large_table_rows=db.large_table_rows)
    for (q, spec, pseed), out in zip(reqs, outs):
        assert not isinstance(out, Exception), out
        alone = again.run_pilot(q, spec, pseed)
        np.testing.assert_array_equal(out.pilot.block_sums, alone.pilot.block_sums)


def _lane(rng, n_phys, br, mg, channels, scratch):
    """One lane's (vals, keys): rows of n_phys blocks of br rows, group ids
    in [0, mg), and ``scratch`` rows moved to the scratch block n_phys."""
    rows = n_phys * br
    vals = torch.from_numpy(rng.standard_normal((channels, rows)).astype(np.float32))
    keys = np.repeat(np.arange(n_phys), br) * mg + rng.integers(0, mg, rows)
    out = rng.choice(rows, scratch, replace=False)
    keys[out] = n_phys * mg + rng.integers(0, mg, scratch)
    return vals, torch.from_numpy(keys.astype(np.int64))


@pytest.mark.parametrize("scratch", [0, 37])
def test_stacked_segment_sum_is_bitwise_the_solo_calls(scratch):
    """ONE slab-claim call over B lanes with ``stack_lane_keys`` is bitwise
    B solo calls; lane 0's rows outside its pilot blocks stay dropped.  A
    bare offset would move them into lane 1's first segments: the slab
    claim then breaks, and without the claim the sums change."""
    rng = np.random.default_rng(4)
    n_phys, br, mg, ch, batch = 24, 32, 3, 4, 3
    width = n_phys * mg
    lanes = [_lane(rng, n_phys, br, mg, ch, scratch if b == 0 else 0)
             for b in range(batch)]
    solo = [segment_sum(v, k, width, slab_rows=br, slab_keys=mg) for v, k in lanes]
    vals = torch.cat([v for v, _ in lanes], dim=1)
    keys = physical.stack_lane_keys([k for _, k in lanes], width)
    stacked = segment_sum(vals, keys, batch * width, slab_rows=br, slab_keys=mg)
    for b in range(batch):
        assert torch.equal(stacked[:, b * width:(b + 1) * width], solo[b])
    bare = torch.cat([k + b * width for b, (_, k) in enumerate(lanes)])
    if scratch:
        with pytest.raises(ValueError, match="slab claim broken"):
            segment_sum(vals, bare, batch * width, slab_rows=br, slab_keys=mg)
        assert not torch.equal(segment_sum(vals, bare, batch * width)[:, width:2 * width],
                               solo[1])


def test_a_failing_stacked_call_fails_each_member_without_a_solo_rerun(
        catalogs, monkeypatch):
    _, port = catalogs

    def broken(*a, **kw):
        raise RuntimeError("stacked launch refused")

    monkeypatch.setattr(physical, "filtered_agg_batched", broken)
    ex = Executor(port, device="cpu")
    solo = []
    execute_pilot = ex.execute_pilot
    ex.execute_pilot = lambda *a, **kw: solo.append(a) or execute_pilot(*a, **kw)
    db = t_taqa.PilotDB(ex, large_table_rows=50_000)
    outs = db.run_pilots_batched(_reqs("q6", t_taqa, t_spec, t_L, t_expr))
    assert all(isinstance(o, RuntimeError) and "refused" in str(o) for o in outs)
    assert (ex.device_dispatches, ex.pilots_run, solo) == (1, 3, [])


def test_drain_cache_counters_match_the_reference(catalogs):
    """The same herd drained in both packages (the reference on its XLA
    route, where it stacks too): equal pilot stages and equal pilot and
    batched compile hits and misses."""
    ref, port = catalogs
    q6 = ("SELECT SUM(l_extendedprice * l_discount) AS rev FROM lineitem "
          "WHERE l_quantity < {} ERROR 8% CONFIDENCE 95%")
    sc = "SELECT SUM(l_extendedprice) AS s, COUNT(*) AS n FROM lineitem ERROR {}% CONFIDENCE 95%"
    grouped = ("SELECT SUM(l_quantity) AS qty, COUNT(*) AS n FROM lineitem "
               "WHERE l_shipdate < {} GROUP BY l_returnflag" + GUARANTEE)
    herd = ([q6.format(c) for c in (18, 21, 24, 27)] + [sc.format(e) for e in (5, 6)]
            + [grouped.format(x) for x in (1800, 2000, 2200)])
    cfg = dict(async_workers=0, result_cache_size=0)
    ts = Session(port, seed=21, device="cpu", config=SessionConfig(**cfg))
    rs = ref_api.Session(ref, seed=21, config=ref_api.SessionConfig(**cfg))
    try:
        for s in (ts, rs):
            hs = [s.submit(q) for q in herd]
            s.drain()
            assert all(h.status == "done" for h in hs)
        assert ts.scheduler.last_drain.pilots_run == rs.scheduler.last_drain.pilots_run
        assert ts.executor.pilots_run == rs.executor.pilots_run
        t, r = ts.compile_cache_info(), rs.compile_cache_info()
        for k in ("pilot_hits", "pilot_misses", "batched_hits", "batched_misses"):
            assert getattr(t, k) == getattr(r, k), k
        stacked = [k for k in ts.executor.physical._cache if k[0] == "pilot_batched"]
        assert len(stacked) == 2             # the Q6 stack and the grouped stack
    finally:
        ts.close(), rs.close()
