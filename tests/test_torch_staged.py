"""The sample catalog (``repro_torch.engine.staged``) against the reference
and against itself, on the CPU.

Both packages build ``tpch_catalog(24_000, 64, seed=3)`` from the same numpy
seed (the port's with ``device="cpu"``).  The reference runs its ``xla``
route, where its staging is live.  Against it the port must give equal
staging seeds, rung ids, sub-draw positions, sampled block ids, staged hit /
miss counters and fallbacks; answers within rtol 1e-5 and pilot block
statistics within rtol 1e-5 (the tolerance between the reference's own
kernel and XLA routes).

Inside the port the contract is bitwise: a table registered with
``staged_rates=`` pins ONE staging realization, and every block draw of it —
staged hit or fresh miss, pilot or final, on the column kernels' route or the
gather route — replays it, so staged answers equal fresh ones bit for bit,
before and after eviction.  The bitwise *reference* inside the port is an
executor whose ladder can never serve (one rung at rate 1e-9): every query
misses to a fresh draw under the same pinned seed.

The reference's ``test_gateway_payload_staged_section`` waits for the port's
gateway (``serve/``, ROADMAP queue 1 item 10).
"""

import dataclasses

import numpy as np
import pytest
import torch

import repro.api as ref_api
import repro.engine.expr as r_expr
import repro.engine.logical as r_L
from repro.engine.datagen import tpch_catalog as ref_tpch_catalog
from repro.engine.executor import Executor as RefExecutor
from repro.engine.sampling import draw_block_ids as ref_draw_block_ids
from repro.engine.sampling import subdraw_positions as ref_subdraw_positions
from repro.engine.staged import build_ladder as ref_build_ladder
from repro.engine.staged import prepare_mono_subdraw as ref_prepare_mono_subdraw
import repro_torch.engine.expr as t_expr
import repro_torch.engine.logical as t_L
from repro_torch.api import Session, SessionConfig
from repro_torch.dist import DistExecutor
from repro_torch.engine.datagen import tpch_catalog
from repro_torch.engine.executor import EmptySampleError, Executor
from repro_torch.engine.physical import ScanRuntime, plan_constants
from repro_torch.engine.sampling import (bucket_blocks, draw_block_ids,
                                         pad_block_ids, subdraw_positions)
from repro_torch.engine.staged import (DEFAULT_STAGED_RATES, build_ladder,
                                       prepare_mono_subdraw, validate_rates)
from repro_torch.kernels.block_agg import block_agg
from repro_torch.kernels.filtered_agg import filtered_agg
from repro_torch.kernels.segment_sum import segment_sum

ROWS, BLOCK_ROWS = 24_000, 64
SEED = 11

# A ladder whose single rung covers no realistic rate: every query misses
# to a fresh draw under the ladder's pinned seed — the bitwise reference.
NEVER = [1e-9]
LADDER = [0.01, 0.04, 0.16, 0.5]


@pytest.fixture(scope="module")
def catalogs():
    return (ref_tpch_catalog(ROWS, BLOCK_ROWS, seed=3),
            tpch_catalog(ROWS, BLOCK_ROWS, seed=3, device="cpu"))


@pytest.fixture(scope="module")
def catalog(catalogs):
    return catalogs[1]


# The three shapes a staged scan takes: the grouped Q6 of the reference's
# tests (gather route), the ungrouped Q6 (filtered_agg) and SUM/COUNT
# (block_agg).
def base_plan(L, E, shape="grouped", cap=24):
    if shape == "sum_count":
        return L.Aggregate(child=L.Scan("lineitem"),
                           aggs=(L.AggSpec("sum", E.Col("l_extendedprice"), "s"),
                                 L.AggSpec("count", None, "n")))
    pred = E.And(E.Col("l_shipdate").between(100, 1500), E.Col("l_quantity") < cap)
    aggs = (L.AggSpec("sum", E.Col("l_extendedprice") * E.Col("l_discount"), "rev"),
            L.AggSpec("count", None, "cnt"))
    if shape == "q6":
        return L.Aggregate(child=L.Filter(L.Scan("lineitem"), pred), aggs=aggs)
    return L.Aggregate(child=L.Filter(L.Scan("lineitem"), pred),
                       aggs=aggs + (L.AggSpec("avg", E.Col("l_quantity"), "aq"),),
                       group_by="l_returnflag", max_groups=3)


def sampled(L, E, seed, rate=0.12, cap=24, shape="grouped"):
    return L.rewrite_scans(base_plan(L, E, shape, cap),
                           {"lineitem": L.SampleClause("block", rate, seed)})


def q6_plan(seed, rate=0.12, cap=24, shape="grouped"):
    return sampled(t_L, t_expr, seed, rate, cap, shape)


def ref_q6_plan(seed, rate=0.12, cap=24, shape="grouped"):
    return sampled(r_L, r_expr, seed, rate, cap, shape)


def staged_executor(catalog, rates, *, seed=0, **kw):
    ex = Executor(dict(catalog), device="cpu", **kw)
    ex.register_staged("lineitem", rates, seed=seed)
    return ex


def ref_staged_executor(ref_catalog, rates, *, seed=0):
    ex = RefExecutor(dict(ref_catalog), kernel_mode="xla")
    ex.register_staged("lineitem", rates, seed=seed)
    return ex


def bits(a):
    return np.asarray(a, np.float64).view(np.int64)


def assert_bitwise(a, b):
    np.testing.assert_array_equal(bits(a), bits(b))


# ---------------------------------------------------------------------------
# The restriction invariant + ladder construction
# ---------------------------------------------------------------------------

def test_subdraw_is_restriction_of_rung():
    n, seed = 5000, 42
    rung_ids = draw_block_ids(n, 0.16, seed)
    np.testing.assert_array_equal(rung_ids, ref_draw_block_ids(n, 0.16, seed))
    for rate in (0.001, 0.01, 0.04, 0.16):
        sub_ids, positions = subdraw_positions(rung_ids, n, rate, seed)
        # the sub-draw IS the fresh draw at that rate (same realization) ...
        np.testing.assert_array_equal(sub_ids, draw_block_ids(n, rate, seed))
        # ... and every sub-drawn id is addressed by its rung position
        np.testing.assert_array_equal(rung_ids[positions], sub_ids)
        r_ids, r_pos = ref_subdraw_positions(rung_ids, n, rate, seed)
        np.testing.assert_array_equal(sub_ids, r_ids)
        np.testing.assert_array_equal(positions, r_pos)
        assert positions.dtype == r_pos.dtype


def test_validate_rates():
    assert validate_rates([0.16, 0.01, 0.04]) == (0.01, 0.04, 0.16)
    assert validate_rates([1.0]) == (1.0,)
    for bad in ([], [0.0], [1.5]):
        with pytest.raises(ValueError):
            validate_rates(bad)
    assert DEFAULT_STAGED_RATES == (0.01, 0.04, 0.16)


def test_rung_selection_smallest_covering(catalogs):
    ref_cat, catalog = catalogs
    lad = build_ladder("lineitem", catalog["lineitem"], LADDER, 7, dict(catalog))
    ref = ref_build_ladder("lineitem", ref_cat["lineitem"], LADDER, 7, "xla",
                           dict(ref_cat))
    assert lad.rung_for(0.005).rate == 0.01
    assert lad.rung_for(0.01).rate == 0.01   # exact match, no eps rejection
    assert lad.rung_for(0.05).rate == 0.16
    assert lad.rung_for(0.3).rate == 0.5
    assert lad.rung_for(0.7) is None          # above the top rung
    for mine, theirs in zip(lad.rungs, ref.rungs):
        np.testing.assert_array_equal(mine.ids, theirs.ids)
        assert mine.nbytes == theirs.nbytes
    # rung tensors are the table's sampled slabs with global lineage intact
    rung = lad.rung_for(0.01)
    assert rung.table.num_blocks == len(rung.ids)
    assert rung.table.num_origin_blocks == catalog["lineitem"].num_blocks
    np.testing.assert_array_equal(
        rung.table.block_id.numpy().reshape(-1, BLOCK_ROWS)[:, 0], rung.ids)
    ref_rung = ref.rung_for(0.01)
    for c, v in rung.table.columns.items():
        np.testing.assert_array_equal(v.numpy(), np.asarray(ref_rung.table.columns[c]))
    np.testing.assert_array_equal(rung.table.valid.numpy(),
                                  np.asarray(ref_rung.table.valid))


def test_prepare_mono_subdraw_memoizes(catalogs):
    ref_cat, catalog = catalogs
    lad = build_ladder("lineitem", catalog["lineitem"], LADDER, 7, dict(catalog))
    rung = lad.rung_for(0.04)
    s1 = prepare_mono_subdraw(lad, rung, 0.03)
    s2 = prepare_mono_subdraw(lad, rung, 0.03)
    assert s1 is s2  # warm path skips the host RNG entirely
    # the forced physical count matches the fresh path's bucketing
    assert s1.n_phys == min(bucket_blocks(max(s1.n_real, 1)),
                            catalog["lineitem"].num_blocks)
    assert len(s1.phys) == s1.n_phys
    # the device copies, made once, on the rung's device
    assert s1.phys_dev.dtype == torch.int32 and s1.nreal_dev.dtype == torch.int32
    assert s1.phys_dev.device == rung.table.device
    np.testing.assert_array_equal(s1.phys_dev.numpy(), s1.phys)
    assert int(s1.nreal_dev) == s1.n_real
    ref = ref_build_ladder("lineitem", ref_cat["lineitem"], LADDER, 7, "xla",
                           dict(ref_cat))
    r = ref_prepare_mono_subdraw(ref, ref.rung_for(0.04), 0.03)
    np.testing.assert_array_equal(s1.sub_ids, r.sub_ids)
    np.testing.assert_array_equal(s1.phys, r.phys)
    assert (s1.n_real, s1.n_phys) == (r.n_real, r.n_phys)


def test_subdraw_n_phys_exceeds_rung_blocks(catalog):
    """The forced fresh n_phys is bucketed against the ORIGIN block count,
    so it may exceed the rung's own: every route must take positions past
    nothing but the rung's blocks, and stay bitwise the fresh draw."""
    ref = staged_executor(catalog, NEVER)
    hot = staged_executor(catalog, [0.16])
    lad = hot.staged.ladder("lineitem")
    rung = lad.rung_for(0.15)
    sub = prepare_mono_subdraw(lad, rung, 0.15)
    assert sub.n_phys > rung.table.num_blocks > sub.n_real
    for shape in ("grouped", "q6", "sum_count"):
        plan = q6_plan(seed=4, rate=0.15, shape=shape)
        assert_bitwise(hot.execute(plan).values, ref.execute(plan).values)
        ps_hot = hot.execute_pilot(t_L.strip_samples(plan), "lineitem", 0.15, seed=1)
        ps_ref = ref.execute_pilot(t_L.strip_samples(plan), "lineitem", 0.15, seed=1)
        assert_bitwise(ps_hot.block_sums, ps_ref.block_sums)
    assert hot.staged.hits == 6 and hot.staged.misses == 0


# ---------------------------------------------------------------------------
# The padding contract: padding ids are masked by n_real, never by what
# they read
# ---------------------------------------------------------------------------

def _padding_catalog(catalog):
    """lineitem with table block 0 all invalid and zero: a fresh draw's
    padding reads it, while a staged sub-draw's padding reads rung
    position 0, a real block with non-zero rows.  Prices are negated, so a
    padding row masked by multiplying with 0 would turn -0.0 on the rung
    and +0.0 on the table."""
    t = catalog["lineitem"]
    zero = lambda v: torch.cat([torch.zeros_like(v[:BLOCK_ROWS]), v[BLOCK_ROWS:]])
    cols = {c: zero(v) for c, v in t.columns.items()}
    cols["l_extendedprice"] = -cols["l_extendedprice"]
    return {**catalog, "lineitem": dataclasses.replace(
        t, columns=cols, valid=zero(t.valid))}


@pytest.mark.parametrize("shape,route", [("q6", "filtered_agg"),
                                         ("sum_count", "block_agg"),
                                         ("grouped", "gather")])
def test_padding_contract_staged_position_zero_vs_table_block_zero(catalog, shape, route):
    cat = _padding_catalog(catalog)
    fresh = Executor(dict(cat), device="cpu")
    hot = staged_executor(cat, [0.16], seed=5)
    lad = hot.staged.ladder("lineitem")
    rung = lad.rung_for(0.1)
    assert rung.ids[0] != 0
    first = rung.table.columns["l_extendedprice"][:BLOCK_ROWS]
    assert bool((first < 0).any()) and bool(rung.table.valid[:BLOCK_ROWS].any())
    plan = base_plan(t_L, t_expr, shape)
    sub = prepare_mono_subdraw(lad, rung, 0.1)
    assert sub.n_phys > sub.n_real  # there is padding to mask
    ids = draw_block_ids(cat["lineitem"].num_blocks, 0.1, lad.seed)
    np.testing.assert_array_equal(ids, sub.sub_ids)
    phys, n_real, n_phys = pad_block_ids(ids, cat["lineitem"].num_blocks)
    assert (n_real, n_phys) == (sub.n_real, sub.n_phys)
    staged_rt = ScanRuntime("block", sub.n_real, sub.n_phys, sub.phys,
                            ids_dev=sub.phys_dev, nreal_dev=sub.nreal_dev)
    fresh_rt = ScanRuntime("block", n_real, n_phys, phys)
    params = plan_constants(plan)
    # the pilot lowering: every per-block row, padding rows included, bitwise
    cs = rung.compiler.compile_pilot(plan, "lineitem", staged_rt)
    cf = fresh.physical.compile_pilot(plan, "lineitem", fresh_rt)
    assert cs.route == cf.route == route
    bs_s, pr_s, _ = cs({"lineitem": staged_rt}, params)
    bs_f, pr_f, _ = cf({"lineitem": fresh_rt}, params)
    assert torch.equal(bs_s.view(torch.int32), bs_f.view(torch.int32))
    assert torch.equal(pr_s, pr_f)
    assert not bool(bs_s[n_real:].view(torch.int32).any())  # padding rows +0.0
    # the final lowering: the same sums and counts, bit for bit
    plan_s = t_L.rewrite_scans(plan, {"lineitem": t_L.SampleClause("block", 0.1, 0)})
    qs = rung.compiler.compile_query(plan_s, {"lineitem": staged_rt})
    qf = fresh.physical.compile_query(plan_s, {"lineitem": fresh_rt})
    assert qs.route == qf.route == route
    for a, b in zip(qs({"lineitem": staged_rt}, params),
                    qf({"lineitem": fresh_rt}, params)):
        assert torch.equal(a.view(torch.int32), b.view(torch.int32))


# ---------------------------------------------------------------------------
# Executor-level bit-identity: finals and pilots
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("shape", ["grouped", "q6", "sum_count"])
def test_staged_final_bit_identical_and_counted(catalogs, shape):
    ref_cat, catalog = catalogs
    ref = staged_executor(catalog, NEVER)
    hot = staged_executor(catalog, LADDER)
    theirs = ref_staged_executor(ref_cat, LADDER)
    kernel = {"q6": filtered_agg, "sum_count": block_agg, "grouped": segment_sum}[shape]
    before = kernel.calls
    for i, rate in enumerate((0.01, 0.035, 0.12, 0.4)):
        plan = q6_plan(seed=100 + i, rate=rate, cap=20 + i, shape=shape)
        a_ref = ref.execute(plan)
        a_hot = hot.execute(plan)
        assert_bitwise(a_ref.values, a_hot.values)
        np.testing.assert_array_equal(a_ref.group_present, a_hot.group_present)
        assert a_ref.scanned_bytes == a_hot.scanned_bytes
        np.testing.assert_array_equal(
            a_hot.sample_infos["lineitem"].sampled_block_ids,
            a_ref.sample_infos["lineitem"].sampled_block_ids)
        r = theirs.execute(ref_q6_plan(seed=100 + i, rate=rate, cap=20 + i, shape=shape))
        np.testing.assert_array_equal(
            a_hot.sample_infos["lineitem"].sampled_block_ids,
            r.sample_infos["lineitem"].sampled_block_ids)
        assert a_hot.sample_infos["lineitem"].seed == r.sample_infos["lineitem"].seed
        np.testing.assert_allclose(a_hot.values, np.asarray(r.values), rtol=1e-5)
        np.testing.assert_array_equal(a_hot.group_present, np.asarray(r.group_present))
    assert kernel.calls > before  # the staged and fresh finals took its route
    assert hot.staged.hits == 4 and hot.staged.misses == 0
    assert ref.staged.hits == 0 and ref.staged.misses == 4
    assert (theirs.staged.hits, theirs.staged.misses) == (4, 0)
    info = hot.compile_cache_info()
    assert info.staged_hits == 4 and info.staged_misses == 0


def test_staged_rate_above_top_rung_falls_back_bit_identically(catalogs):
    ref_cat, catalog = catalogs
    ref = staged_executor(catalog, NEVER)
    hot = staged_executor(catalog, [0.01, 0.04])   # top rung 4%
    plan = q6_plan(seed=5, rate=0.3)               # required rate above it
    assert_bitwise(ref.execute(plan).values, hot.execute(plan).values)
    assert hot.staged.hits == 0 and hot.staged.misses == 1
    theirs = ref_staged_executor(ref_cat, [0.01, 0.04])
    theirs.execute(ref_q6_plan(seed=5, rate=0.3))
    assert (theirs.staged.hits, theirs.staged.misses) == (0, 1)


@pytest.mark.parametrize("shape", ["grouped", "q6", "sum_count"])
def test_staged_pilot_stats_bit_identical(catalogs, shape):
    ref_cat, catalog = catalogs
    ref = staged_executor(catalog, NEVER)
    hot = staged_executor(catalog, LADDER)
    base = base_plan(t_L, t_expr, shape)  # pilots run on the unsampled plan
    p_ref = ref.execute_pilot(base, "lineitem", 0.03, seed=123)
    p_hot = hot.execute_pilot(base, "lineitem", 0.03, seed=123)
    assert p_ref.n_sampled_blocks == p_hot.n_sampled_blocks > 0
    assert_bitwise(p_ref.block_sums, p_hot.block_sums)
    np.testing.assert_array_equal(p_ref.group_present, p_hot.group_present)
    assert p_ref.scanned_bytes == p_hot.scanned_bytes
    assert hot.staged.hits == 1 and ref.staged.misses == 1
    theirs = ref_staged_executor(ref_cat, LADDER)
    p = theirs.execute_pilot(base_plan(r_L, r_expr, shape), "lineitem", 0.03, seed=123)
    assert p.n_sampled_blocks == p_hot.n_sampled_blocks
    np.testing.assert_allclose(p_hot.block_sums, np.asarray(p.block_sums),
                               rtol=1e-5, atol=1e-6)
    np.testing.assert_array_equal(p_hot.group_present, np.asarray(p.group_present))
    assert (theirs.staged.hits, theirs.staged.misses) == (1, 0)


def test_staged_empty_subdraw_raises_like_fresh(catalog):
    # a rate far below 1/num_blocks: the pinned realization has no block
    # below the threshold, so BOTH paths see an empty sample
    ref = staged_executor(catalog, NEVER)
    hot = staged_executor(catalog, LADDER)
    rate = 1e-7
    assert len(draw_block_ids(catalog["lineitem"].num_blocks, rate, 0)) == 0
    with pytest.raises(EmptySampleError):
        hot.execute(q6_plan(seed=1, rate=rate))
    with pytest.raises(EmptySampleError):
        ref.execute(q6_plan(seed=1, rate=rate))
    assert hot.staged.hits == 1  # the staged route served the empty verdict


def _scaled(table, column, factor):
    return dataclasses.replace(
        table, columns={**table.columns, column: table.columns[column] * factor})


def test_register_table_invalidates_stale_ladder(catalog):
    hot = staged_executor(catalog, LADDER)
    plan = q6_plan(seed=2, rate=0.1)
    old = hot.execute(plan)
    assert hot.staged.hits == 1
    # re-register with DIFFERENT data: the old rung tensors must not serve
    hot.register_table("lineitem", _scaled(catalog["lineitem"], "l_extendedprice", 2.0))
    assert hot.staged_info()["tables"] == {}  # ladder dropped, not re-staged
    # restaging on the new data serves the new values, bitwise a pinned-seed
    # fresh draw of the new data — never the stale rung tensors
    hot.register_staged("lineitem", NEVER, seed=0)
    fresh = hot.execute(plan)
    assert not np.array_equal(old.values, fresh.values)
    hot.register_staged("lineitem", LADDER, seed=0)
    assert_bitwise(fresh.values, hot.execute(plan).values)


def test_refresh_replicated_other_table(catalog):
    # a rung compiler replicates OTHER tables; re-registering one must
    # repoint the replicated entry
    hot = staged_executor(catalog, LADDER)
    doubled = _scaled(catalog["orders"], "o_totalprice", 2.0)
    hot.register_table("orders", doubled)
    for rung in hot.staged.ladder("lineitem").rungs:
        assert rung.compiler.catalog["orders"] is doubled


def test_eviction_keeps_bit_identity(catalogs):
    ref_cat, catalog = catalogs
    ref = staged_executor(catalog, NEVER)
    hot = staged_executor(catalog, LADDER)
    plan = q6_plan(seed=3, rate=0.1)
    before = hot.execute(plan)
    assert hot.staged.hits == 1
    # squeeze the budget: the ladder's tensors are dropped, the record stays
    hot.staged.max_bytes = 0
    with hot.staged._lock:
        hot.staged._enforce_budget()
    info = hot.staged_info()
    assert info["evictions"] == 1 and info["resident_bytes"] == 0
    assert info["tables"]["lineitem"]["resident_rates"] == []
    after = hot.execute(plan)     # misses to a fresh draw, same pinned seed
    assert hot.staged.misses == 1
    assert_bitwise(before.values, after.values)
    assert_bitwise(ref.execute(plan).values, after.values)
    theirs = ref_staged_executor(ref_cat, LADDER)
    theirs.staged.max_bytes = 0
    with theirs.staged._lock:
        theirs.staged._enforce_budget()
    assert theirs.staged_info()["evictions"] == info["evictions"]


def _evict(ex):
    ex.staged.max_bytes = 0
    with ex.staged._lock:
        ex.staged._enforce_budget()


def _race(monkeypatch, ex, when):
    """Let the budget drop every rung at ``when``: "lookup", just after the
    ladder's rung lookup returned a resident rung (between the route's
    choice and the sub-draw), or "subdraw", just after the sub-draw was
    taken (before the dispatch)."""
    if when == "lookup":
        lad = ex.staged.ladder("lineitem")
        lookup = lad.rung_for

        def racing(rate):
            rung = lookup(rate)
            _evict(ex)
            return rung
        monkeypatch.setattr(lad, "rung_for", racing)
    else:
        import repro_torch.engine.executor as executor_mod
        prepare = executor_mod.prepare_mono_subdraw

        def racing(lad, rung, rate):
            sub = prepare(lad, rung, rate)
            _evict(ex)
            return sub
        monkeypatch.setattr(executor_mod, "prepare_mono_subdraw", racing)


@pytest.mark.parametrize("when", ["lookup", "subdraw"])
@pytest.mark.parametrize("shape", ["grouped", "q6", "sum_count"])
def test_eviction_racing_a_staged_query_gives_the_fresh_answer(
        catalog, monkeypatch, shape, when):
    """An eviction between the staged route's rung lookup and its sub-draw
    makes the query a miss, drawn fresh under the pinned seed; one after
    the sub-draw leaves the sub-draw its rung's tensors and compiler.  The
    answer is bitwise the fresh one either way, final and pilot."""
    ref = staged_executor(catalog, NEVER)
    plan = q6_plan(seed=4, rate=0.1, shape=shape)
    pilot = base_plan(t_L, t_expr, shape)
    want = ref.execute(plan)
    want_pilot = ref.execute_pilot(pilot, "lineitem", 0.03, seed=5)
    for run in ("final", "pilot"):
        hot = staged_executor(catalog, LADDER)
        _race(monkeypatch, hot, when)
        if run == "final":
            got = hot.execute(plan)
            assert_bitwise(want.values, got.values)
            np.testing.assert_array_equal(
                got.sample_infos["lineitem"].sampled_block_ids,
                want.sample_infos["lineitem"].sampled_block_ids)
        else:
            got = hot.execute_pilot(pilot, "lineitem", 0.03, seed=5)
            assert got.n_sampled_blocks == want_pilot.n_sampled_blocks > 0
            assert_bitwise(want_pilot.block_sums, got.block_sums)
        assert hot.staged.evictions == 1
        assert ((hot.staged.hits, hot.staged.misses)
                == ((0, 1) if when == "lookup" else (1, 0)))
        monkeypatch.undo()


def test_a_dropped_rung_serves_no_subdraw(catalog):
    hot = staged_executor(catalog, LADDER)
    lad = hot.staged.ladder("lineitem")
    rung = lad.rung_for(0.03)
    assert prepare_mono_subdraw(lad, rung, 0.03).compiler is rung.compiler
    _evict(hot)
    assert prepare_mono_subdraw(lad, rung, 0.03) is None
    assert lad._memo == {}


def test_staged_bytes_budget_evicts_lru(catalogs):
    ref_cat, catalog = catalogs
    one = build_ladder("lineitem", catalog["lineitem"], [0.04], 0, dict(catalog))
    nbytes = one.resident_bytes
    assert nbytes > 0
    ex = Executor(dict(catalog), device="cpu", staged_bytes=int(nbytes))
    ex.register_staged("lineitem", [0.04], seed=0)
    ex.register_staged("orders", [0.04], seed=0)   # busts the budget
    info = ex.staged_info()
    assert info["evictions"] == 1
    # the LRU victim is lineitem (registered first, never used since)
    assert info["tables"]["lineitem"]["resident_rates"] == []
    assert info["tables"]["orders"]["resident_rates"] == [0.04]
    theirs = RefExecutor(dict(ref_cat), kernel_mode="xla", staged_bytes=int(nbytes))
    theirs.register_staged("lineitem", [0.04], seed=0)
    theirs.register_staged("orders", [0.04], seed=0)
    assert theirs.staged_info() == info


def test_batched_members_route_staged_solo(catalogs):
    ref_cat, catalog = catalogs
    ref = staged_executor(catalog, NEVER)
    hot = staged_executor(catalog, LADDER)
    plans = [q6_plan(seed=10 + i, rate=0.08, cap=18 + i) for i in range(4)]
    for a, b in zip(ref.execute_batch(plans), hot.execute_batch(plans)):
        assert_bitwise(a.values, b.values)
    assert hot.staged.hits == 4
    theirs = ref_staged_executor(ref_cat, LADDER)
    outs = theirs.execute_batch([ref_q6_plan(seed=10 + i, rate=0.08, cap=18 + i)
                                 for i in range(4)])
    for a, b in zip(hot.execute_batch(plans), outs):
        np.testing.assert_allclose(a.values, np.asarray(b.values), rtol=1e-5)
    assert theirs.staged.hits == 4


# ---------------------------------------------------------------------------
# Session-level: ladder configs x shard counts, herds, cached re-issues
# ---------------------------------------------------------------------------

SQLS = [
    "SELECT SUM(l_extendedprice * l_discount) AS rev FROM lineitem "
    "WHERE l_quantity < 24 ERROR 8% CONFIDENCE 90%",
    "SELECT AVG(l_quantity) AS aq, COUNT(*) AS n FROM lineitem "
    "WHERE l_shipdate BETWEEN 100 AND 1500 GROUP BY l_returnflag "
    "MAXGROUPS 3 ERROR 10% CONFIDENCE 90%",
]


def _answers(catalog, staged_rates, shards, ref=False):
    if ref:
        session = ref_api.Session(seed=SEED, config=ref_api.SessionConfig(
            large_table_rows=10_000, result_cache_size=0, kernel_mode="xla"))
    else:
        session = Session(seed=SEED, device="cpu", config=SessionConfig(
            large_table_rows=10_000, result_cache_size=0))
    session.register_table("lineitem", catalog["lineitem"], shards=shards,
                           staged_rates=staged_rates)
    out = []
    for sql in SQLS:
        h = session.sql(sql)
        a = h.result()
        out.append((np.asarray(a.values), np.asarray(a.group_present), h.fallback))
    stats = (session.executor.staged.hits, session.executor.staged.misses)
    session.close()
    return out, stats


@pytest.mark.parametrize("rates", [LADDER, [0.5], True, NEVER],
                         ids=["ladder", "half", "default", "never"])
def test_session_bit_identity_across_ladders_and_shards(catalogs, rates):
    ref_cat, catalog = catalogs
    base, _ = _answers(catalog, NEVER, None)
    theirs, their_stats = _answers(ref_cat, rates, None, ref=True)
    for shards in (None, 1, 2, 4):
        got, stats = _answers(catalog, rates, shards)
        for (rv, rp, rf), (gv, gp, gf) in zip(base, got):
            assert_bitwise(rv, gv)
            np.testing.assert_array_equal(rp, gp)
            assert rf == gf
        assert stats == their_stats  # staged hits and misses, as the reference
        if rates is not NEVER:
            assert stats[0] > 0  # the rungs really served
    for (tv, tp, tf), (gv, gp, gf) in zip(theirs, base):
        np.testing.assert_allclose(gv, tv, rtol=1e-5)
        np.testing.assert_array_equal(gp, tp)
        assert gf == tf


def test_session_staged_rates_none_is_todays_behavior(catalog):
    cfg = SessionConfig(large_table_rows=10_000)
    plain, staged_off = [], []
    for out, kw in ((plain, {}), (staged_off, {"staged_rates": None})):
        session = Session(seed=SEED, device="cpu", config=cfg)
        session.register_table("lineitem", catalog["lineitem"], **kw)
        for sql in SQLS:
            out.append(session.sql(sql).result().values)
        assert session.executor.staged_info()["tables"] == {}
        session.close()
    for a, b in zip(plain, staged_off):
        assert_bitwise(a, b)


def test_session_herd_shared_pilots_and_cache_bit_identical(catalog):
    herd = ["SELECT SUM(l_extendedprice * l_discount) AS rev FROM lineitem "
            f"WHERE l_quantity < {cap} ERROR 8% CONFIDENCE 90%"
            for cap in (24, 24, 20, 22)]     # verbatim re-issue + constants
    results = {}
    for key, rates in (("ref", NEVER), ("hot", LADDER)):
        cfg = SessionConfig(large_table_rows=10_000, share_pilots=True,
                            result_cache_size=32)
        session = Session(seed=SEED, device="cpu", config=cfg)
        session.register_table("lineitem", catalog["lineitem"], staged_rates=rates)
        handles = [session.submit(s) for s in herd]
        session.drain()
        first = [h.result().values for h in handles]
        rerun = [session.sql(s).result().values for s in herd]
        assert session.result_cache_info().hits > 0  # re-issues were cached
        results[key] = first + rerun
        if key == "hot":
            assert session.executor.staged.hits > 0
        session.close()
    for a, b in zip(results["ref"], results["hot"]):
        assert_bitwise(a, b)


def test_session_validates_staged_rates_before_registering(catalog):
    session = Session(seed=SEED, device="cpu")
    with pytest.raises(ValueError):
        session.register_table("lineitem", catalog["lineitem"], staged_rates=[2.0])
    assert "lineitem" not in session.executor.catalog  # rejected atomically
    session.close()


def test_session_staging_seed_is_the_references(catalogs):
    ref_cat, catalog = catalogs
    mine = Session(seed=SEED, device="cpu")
    theirs = ref_api.Session(seed=SEED)
    for name in ("lineitem", "orders"):
        assert mine._staged_seed_for(name) == theirs._staged_seed_for(name)
    mine.register_table("lineitem", catalog["lineitem"], staged_rates=True)
    theirs.register_table("lineitem", ref_cat["lineitem"], staged_rates=True)
    a = mine.executor.staged.ladder("lineitem")
    b = theirs.executor.staged.ladder("lineitem")
    assert a.seed == b.seed and a.rates == b.rates
    for x, y in zip(a.rungs, b.rungs):
        np.testing.assert_array_equal(x.ids, y.ids)
    mine.close()
    theirs.close()


def test_session_exact_fallback_on_empty_staged_sample():
    # a 3-block toy table: the pinned realization at the pilot rate is
    # empty, the pilot escalates, and if everything stays empty the session
    # falls back to the exact answer — identically with and without rungs
    tiny = tpch_catalog(3 * BLOCK_ROWS, BLOCK_ROWS, seed=5, device="cpu")
    ref_tiny = ref_tpch_catalog(3 * BLOCK_ROWS, BLOCK_ROWS, seed=5)
    out = []
    for rates in (NEVER, LADDER):
        session = Session(seed=SEED, device="cpu",
                          config=SessionConfig(large_table_rows=64))
        session.register_table("lineitem", tiny["lineitem"], staged_rates=rates)
        h = session.sql(SQLS[0])
        out.append((h.result().values, h.fallback))
        session.close()
    assert_bitwise(out[0][0], out[1][0])
    assert out[0][1] == out[1][1]
    theirs = ref_api.Session(seed=SEED, config=ref_api.SessionConfig(
        large_table_rows=64, kernel_mode="xla"))
    theirs.register_table("lineitem", ref_tiny["lineitem"], staged_rates=LADDER)
    h = theirs.sql(SQLS[0])
    assert h.fallback == out[1][1]
    np.testing.assert_allclose(out[1][0], np.asarray(h.result().values), rtol=1e-5)
    theirs.close()


def test_dist_executor_staged_info_reports_sharded(catalog):
    ex = DistExecutor(dict(catalog), device="cpu")
    ex.register_sharded("lineitem", catalog["lineitem"], 3)
    ex.register_staged("lineitem", LADDER, seed=0)
    info = ex.staged_info()
    assert info["tables"]["lineitem"]["sharded"] is True
    assert info["tables"]["lineitem"]["resident_bytes"] > 0
