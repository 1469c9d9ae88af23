"""Partitioned tables and shard-parallel execution (``repro_torch.dist``)
against the reference and against itself, on the CPU.

Both packages build ``tpch_catalog(24_000, 64, seed=3)`` from the same numpy
seed (the port's with ``device="cpu"``); the reference runs its ``xla``
route.  Against it the port must give equal shard partitions, sampled block
ids, per-shard scanned bytes, fallbacks and pilot counts; answers and pilot
block statistics within rtol 1e-5.

Inside the port the load-bearing property is bitwise: for a fixed session
seed a table registered with ANY shard count answers bit-identically —
sampled finals, pilots, shared-pilot herds, cached re-issues and exact
fallbacks included — and a serial drain equals one whose pilot subgroups fan
out over threads.  The sampled block set is the one content-derived
realization restricted per shard, and all cross-shard state moves at
per-block granularity.
"""

import numpy as np
import pytest
import torch

import repro.api as ref_api
import repro.engine.expr as r_expr
import repro.engine.logical as r_L
from repro.dist import DistExecutor as RefDistExecutor
from repro.dist import ShardedTable as RefShardedTable
from repro.engine.datagen import tpch_catalog as ref_tpch_catalog
import repro_torch.engine.expr as t_expr
import repro_torch.engine.logical as t_L
from repro_torch.api import Session, SessionConfig
from repro_torch.core.spec import CompositeAgg, ErrorSpec
from repro_torch.core.taqa import Query
from repro_torch.dist import (DistExecutor, ShardedTable, merge_block_stats,
                              reduce_group_totals, shard_block_ids)
from repro_torch.dist.merge import ShardPart
from repro_torch.engine.datagen import tpch_catalog
from repro_torch.engine.executor import EmptySampleError, Executor
from repro_torch.engine.sampling import draw_block_ids
from repro_torch.kernels.block_agg import block_agg
from repro_torch.kernels.filtered_agg import filtered_agg
from repro_torch.kernels.segment_sum import segment_sum

ROWS, BLOCK_ROWS = 24_000, 64
SEED = 11


@pytest.fixture(scope="module")
def catalogs():
    return (ref_tpch_catalog(ROWS, BLOCK_ROWS, seed=3),
            tpch_catalog(ROWS, BLOCK_ROWS, seed=3, device="cpu"))


@pytest.fixture(scope="module")
def catalog(catalogs):
    return catalogs[1]


def _q6(L, E, seed, rate=0.12, shape="grouped"):
    if shape == "sum_count":
        plan = L.Aggregate(child=L.Scan("lineitem"),
                           aggs=(L.AggSpec("sum", E.Col("l_extendedprice"), "s"),
                                 L.AggSpec("count", None, "n")))
    else:
        pred = E.And(E.Col("l_shipdate").between(100, 1500), E.Col("l_quantity") < 24)
        aggs = (L.AggSpec("sum", E.Col("l_extendedprice") * E.Col("l_discount"), "rev"),
                L.AggSpec("count", None, "cnt"))
        if shape == "q6":
            plan = L.Aggregate(child=L.Filter(L.Scan("lineitem"), pred), aggs=aggs)
        else:
            plan = L.Aggregate(
                child=L.Filter(L.Scan("lineitem"), pred),
                aggs=aggs + (L.AggSpec("avg", E.Col("l_quantity"), "aq"),),
                group_by="l_returnflag", max_groups=3)
    return L.rewrite_scans(plan, {"lineitem": L.SampleClause("block", rate, seed)})


def q6_plan(seed, rate=0.12, shape="grouped"):
    return _q6(t_L, t_expr, seed, rate, shape)


def ref_q6_plan(seed, rate=0.12, shape="grouped"):
    return _q6(r_L, r_expr, seed, rate, shape)


def join_plan(L, E):
    return L.Aggregate(
        child=L.Join(L.Scan("lineitem"), L.Scan("orders"), "l_orderkey", "o_orderkey"),
        aggs=(L.AggSpec("sum", E.Col("l_extendedprice"), "rev"),))


def dist_executor(catalog, shards):
    ex = DistExecutor(dict(catalog), device="cpu")
    ex.register_sharded("lineitem", catalog["lineitem"], shards)
    return ex


def ref_dist_executor(ref_catalog, shards):
    ex = RefDistExecutor(dict(ref_catalog), kernel_mode="xla")
    ex.register_sharded("lineitem", ref_catalog["lineitem"], shards)
    return ex


def bits(a):
    return np.asarray(a, np.float64).view(np.int64)


def assert_bitwise(a, b):
    np.testing.assert_array_equal(bits(a), bits(b))


# ---------------------------------------------------------------------------
# Shard geometry + restriction-based sub-draws
# ---------------------------------------------------------------------------

def test_shards_partition_blocks_disjoint_and_complete(catalogs):
    ref_cat, catalog = catalogs
    table = catalog["lineitem"]
    st = ShardedTable.from_table(table, 3)
    ref = RefShardedTable.from_table(ref_cat["lineitem"], 3)
    assert st.num_blocks == table.num_blocks
    covered = []
    for s, r in zip(st.shards, ref.shards):
        assert (s.start_block, s.end_block) == (r.start_block, r.end_block)
        assert s.end_block > s.start_block
        assert s.table.num_blocks == s.num_blocks
        assert s.table.num_rows == r.table.num_rows
        assert s.table.device == table.device
        # global origin labels survive the slice
        assert int(s.table.block_id[0]) == s.start_block
        np.testing.assert_array_equal(s.table.block_id.numpy(),
                                      np.asarray(r.table.block_id))
        covered.extend(range(s.start_block, s.end_block))
    assert covered == list(range(table.num_blocks))
    # shard data on the table's own device is the base table's slice, a
    # contiguous view of its storage (no copy)
    s1 = st.shards[1]
    lo, hi = s1.start_block * BLOCK_ROWS, s1.end_block * BLOCK_ROWS
    for col, t in [*s1.table.columns.items(), ("valid", s1.table.valid),
                   ("block_id", s1.table.block_id)]:
        base = table.valid if col == "valid" else (
            table.block_id if col == "block_id" else table.columns[col])
        assert t.is_contiguous()
        assert t.data_ptr() == base[lo:hi].data_ptr()
        assert torch.equal(t, base[lo:hi])
    assert (st.block_rows, st.row_bytes) == (ref.block_rows, ref.row_bytes)


def test_shard_counts_validated(catalog):
    table = catalog["lineitem"]
    with pytest.raises(ValueError):
        ShardedTable.from_table(table, 0)
    with pytest.raises(ValueError):
        ShardedTable.from_table(table, table.num_blocks + 1)


@pytest.mark.parametrize("shards", [1, 2, 3, 4, 7])
def test_sub_draws_union_to_the_monolithic_draw(catalogs, shards):
    """Per-shard restriction of the one content-derived realization: the
    union equals the monolithic Bernoulli draw exactly, for any N, and the
    partition is the reference's."""
    ref_cat, catalog = catalogs
    table = catalog["lineitem"]
    st = ShardedTable.from_table(table, shards)
    global_ids, parts = shard_block_ids(table.num_blocks, 0.1, SEED, st)
    np.testing.assert_array_equal(global_ids,
                                  draw_block_ids(table.num_blocks, 0.1, SEED))
    rejoined = np.concatenate([local + s.start_block for s, local in parts])
    np.testing.assert_array_equal(rejoined, global_ids)
    for s, local in parts:
        assert len(local) and local.min() >= 0
        assert local.max() < s.num_blocks
    ref = RefShardedTable.from_table(ref_cat["lineitem"], shards)
    their_parts = ref.partition_ids(global_ids)
    assert [s.index for s, _ in parts] == [s.index for s, _ in their_parts]
    for (_, a), (_, b) in zip(parts, their_parts):
        np.testing.assert_array_equal(a, b)


def test_merge_rejects_out_of_order_parts():
    a = ShardPart(0, np.array([4, 5]), np.zeros((2, 1, 2)))
    b = ShardPart(1, np.array([0, 1]), np.ones((2, 1, 2)))
    with pytest.raises(ValueError):
        merge_block_stats([a, b])
    ids, bs = merge_block_stats([b, a])
    np.testing.assert_array_equal(ids, [0, 1, 4, 5])
    sums, counts = reduce_group_totals(bs)
    assert sums.shape == (1, 1) and counts.shape == (1,)
    assert counts[0] == 2.0  # last channel is the row count


# ---------------------------------------------------------------------------
# Executor-level bit-identity
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("shape", ["grouped", "q6", "sum_count"])
def test_final_bit_identity_across_shard_counts(catalogs, shape):
    ref_cat, catalog = catalogs
    kernel = {"q6": filtered_agg, "sum_count": block_agg, "grouped": segment_sum}[shape]
    before = kernel.calls
    results = {n: dist_executor(catalog, n).execute(q6_plan(7, shape=shape))
               for n in (1, 2, 3, 7)}
    assert kernel.calls > before  # the shards took the plan's route
    for n in (2, 3, 7):
        assert_bitwise(results[n].values, results[1].values)
        assert_bitwise(results[n].group_counts, results[1].group_counts)
        np.testing.assert_array_equal(results[n].group_present,
                                      results[1].group_present)
    theirs = ref_dist_executor(ref_cat, 2).execute(ref_q6_plan(7, shape=shape))
    np.testing.assert_allclose(results[1].values, np.asarray(theirs.values), rtol=1e-5)
    np.testing.assert_array_equal(results[1].group_counts, np.asarray(theirs.group_counts))


def test_final_agrees_with_monolithic_route(catalog):
    """Cross-route agreement with the monolithic executor: counts and the
    group bitmap are bitwise equal (integer summands), values to f32
    rounding (the f64 merge against the device's f32 reduction)."""
    ref = Executor(dict(catalog), device="cpu").execute(q6_plan(7))
    res = dist_executor(catalog, 4).execute(q6_plan(7))
    np.testing.assert_array_equal(res.group_counts, ref.group_counts)
    np.testing.assert_array_equal(res.group_present, ref.group_present)
    np.testing.assert_allclose(res.values, ref.values, rtol=1e-6)
    assert res.scanned_bytes == ref.scanned_bytes
    infos = res.sample_infos["lineitem"]
    assert infos.n_sampled_blocks == ref.sample_infos["lineitem"].n_sampled_blocks


@pytest.mark.parametrize("shape", ["grouped", "q6", "sum_count"])
def test_pilot_statistics_bitwise_equal_to_monolithic(catalogs, shape):
    ref_cat, catalog = catalogs
    plan = t_L.strip_samples(q6_plan(0, shape=shape))
    ref = Executor(dict(catalog), device="cpu").execute_pilot(plan, "lineitem", 0.08, SEED)
    for n in (1, 2, 3, 7):
        ps = dist_executor(catalog, n).execute_pilot(plan, "lineitem", 0.08, SEED)
        assert ps.n_sampled_blocks == ref.n_sampled_blocks
        assert_bitwise(ps.block_sums, ref.block_sums)
        np.testing.assert_array_equal(ps.group_present, ref.group_present)
        assert ps.scanned_bytes == ref.scanned_bytes
    theirs = ref_dist_executor(ref_cat, 3).execute_pilot(
        r_L.strip_samples(ref_q6_plan(0, shape=shape)), "lineitem", 0.08, SEED)
    assert theirs.n_sampled_blocks == ref.n_sampled_blocks
    np.testing.assert_allclose(ref.block_sums, np.asarray(theirs.block_sums),
                               rtol=1e-5, atol=1e-6)


def test_join_pilot_pair_sums_merge_bitwise(catalogs):
    """Lemma-4.8 block-pair statistics (join pilots) concatenate exactly."""
    ref_cat, catalog = catalogs
    plan = join_plan(t_L, t_expr)
    ref = Executor(dict(catalog), device="cpu").execute_pilot(
        plan, "lineitem", 0.08, SEED, pair_tables=("orders",))
    for n in (1, 3):
        ps = dist_executor(catalog, n).execute_pilot(
            plan, "lineitem", 0.08, SEED, pair_tables=("orders",))
        assert_bitwise(ps.block_sums, ref.block_sums)
        assert_bitwise(ps.pair_sums["orders"], ref.pair_sums["orders"])
        assert ps.right_total_blocks == ref.right_total_blocks
    theirs = ref_dist_executor(ref_cat, 3).execute_pilot(
        join_plan(r_L, r_expr), "lineitem", 0.08, SEED, pair_tables=("orders",))
    np.testing.assert_allclose(ref.pair_sums["orders"],
                               np.asarray(theirs.pair_sums["orders"]), rtol=1e-5)


def test_empty_global_draw_raises_empty_sample_error(catalog):
    """A GLOBAL draw of zero blocks raises (TAQA's explicit exact
    fallback); a single empty shard merely contributes nothing."""
    ex = dist_executor(catalog, 4)
    n_blocks = catalog["lineitem"].num_blocks
    empty_seed = next(s for s in range(10_000)
                      if len(draw_block_ids(n_blocks, 0.001, s)) == 0)
    with pytest.raises(EmptySampleError):
        ex.execute(q6_plan(empty_seed, rate=0.001))


def test_compile_cache_info_aggregates_shard_compilers(catalog):
    """Dist dispatches compile in per-shard executors; the top-level
    counters include them (drain stats read those)."""
    ex = dist_executor(catalog, 2)
    assert ex.compile_cache_info().misses == 0
    ex.execute(q6_plan(7))
    first = ex.compile_cache_info()
    assert first.misses >= 2 and first.size >= 2  # one build per shard
    ex.execute(q6_plan(8))  # same shapes: warm
    second = ex.compile_cache_info()
    assert second.misses == first.misses
    assert second.hits > first.hits


def test_per_shard_scanned_bytes_sum_to_monolithic_total(catalogs):
    ref_cat, catalog = catalogs
    totals = {}
    for n in (1, 2, 4):
        ex = dist_executor(catalog, n)
        res = ex.execute(q6_plan(7))
        info = ex.shard_scan_info()["lineitem"]
        assert len(info) == n and all(b > 0 for b in info)
        totals[n] = sum(info)
        assert totals[n] == res.sample_infos["lineitem"].scanned_bytes
        theirs = ref_dist_executor(ref_cat, n)
        theirs.execute(ref_q6_plan(7))
        assert info == theirs.shard_scan_info()["lineitem"]
    assert totals[2] == totals[1] and totals[4] == totals[1]


def test_execute_batch_routes_dist_members_bit_identically(catalog):
    ex = dist_executor(catalog, 2)
    plans = [q6_plan(s) for s in (3, 4, 5, 6)]
    solo = [dist_executor(catalog, 2).execute(p) for p in plans]
    for out, ref in zip(ex.execute_batch(plans), solo):
        assert_bitwise(out.values, ref.values)


def test_multi_table_sampling_falls_back_monolithically(catalog):
    """Plans sampling more than the sharded table run on the monolithic
    tensors — shard-count-independent by definition."""
    sampled = t_L.rewrite_scans(join_plan(t_L, t_expr), {
        "lineitem": t_L.SampleClause("block", 0.2, 5),
        "orders": t_L.SampleClause("block", 0.5, 6)})
    ref = Executor(dict(catalog), device="cpu").execute(sampled)
    for n in (2, 4):
        assert_bitwise(dist_executor(catalog, n).execute(sampled).values, ref.values)


def test_plain_reregistration_drops_sharding(catalog):
    ex = dist_executor(catalog, 4)
    assert ex.sharded_tables() == {"lineitem": 4}
    assert ex.is_sharded("lineitem")
    ex.register_table("lineitem", catalog["lineitem"])
    assert ex.sharded_tables() == {} and not ex.is_sharded("lineitem")
    ref = Executor(dict(catalog), device="cpu").execute(q6_plan(7))
    assert_bitwise(ex.execute(q6_plan(7)).values, ref.values)


def test_staged_shards_bit_identical_to_fresh_shards(catalog):
    """Per-shard rungs: the staged dist route equals the fresh dist route
    (a never-serving ladder) bitwise, for finals and pilots, at every shard
    count, and a rung's sub-draw may need more positions than it holds."""
    plan = q6_plan(9, rate=0.15)
    pilot = t_L.strip_samples(plan)
    out = {}
    for rates in ([1e-9], [0.16]):
        for n in (1, 2, 7):
            ex = dist_executor(catalog, n)
            ex.register_staged("lineitem", rates, seed=3)
            out[(rates[0], n)] = (ex.execute(plan).values,
                                  ex.execute_pilot(pilot, "lineitem", 0.15, 1).block_sums,
                                  ex.staged.hits, ex.staged.misses)
    for key, (v, bs, hits, misses) in out.items():
        assert_bitwise(v, out[(1e-9, 1)][0])
        assert_bitwise(bs, out[(1e-9, 1)][1])
        assert (hits, misses) == ((2, 0) if key[0] == 0.16 else (0, 2))


@pytest.mark.parametrize("when", ["lookup", "subdraw"])
def test_eviction_racing_a_staged_dist_query_gives_the_fresh_answer(
        catalog, monkeypatch, when):
    """An eviction between the dist route's rung lookup and its sub-draw
    makes the query a miss, drawn fresh under the pinned seed (never an
    empty pilot); one after the sub-draw leaves each split its shard
    part's tensors and compiler.  Bitwise the fresh answer either way."""
    import repro_torch.dist.executor as dist_mod
    plan = q6_plan(9, rate=0.15)
    pilot = t_L.strip_samples(plan)
    ref = dist_executor(catalog, 3)
    ref.register_staged("lineitem", [1e-9], seed=3)
    want = ref.execute(plan).values
    want_pilot = ref.execute_pilot(pilot, "lineitem", 0.15, 1)

    def evict(ex):
        ex.staged.max_bytes = 0
        with ex.staged._lock:
            ex.staged._enforce_budget()

    for run in ("final", "pilot"):
        ex = dist_executor(catalog, 3)
        ex.register_staged("lineitem", [0.16], seed=3)
        lad = ex.staged.ladder("lineitem")
        if when == "lookup":
            lookup = lad.rung_for

            def racing(rate):
                rung = lookup(rate)
                evict(ex)
                return rung
            monkeypatch.setattr(lad, "rung_for", racing)
        else:
            prepare = dist_mod.prepare_dist_subdraw

            def racing(lad, rung, rate):
                sub = prepare(lad, rung, rate)
                evict(ex)
                return sub
            monkeypatch.setattr(dist_mod, "prepare_dist_subdraw", racing)
        if run == "final":
            assert_bitwise(want, ex.execute(plan).values)
        else:
            got = ex.execute_pilot(pilot, "lineitem", 0.15, 1)
            assert got.n_sampled_blocks == want_pilot.n_sampled_blocks > 0
            assert_bitwise(want_pilot.block_sums, got.block_sums)
        assert ex.staged.evictions == 1
        assert ((ex.staged.hits, ex.staged.misses)
                == ((0, 1) if when == "lookup" else (1, 0)))
        monkeypatch.undo()


# ---------------------------------------------------------------------------
# Session-level acceptance: the TPC-H-style suite across shard counts
# ---------------------------------------------------------------------------

SUITE = [
    # q6-family filtered SUM (constant-varied herd below slides the cap)
    "SELECT SUM(l_extendedprice * l_discount) AS rev FROM lineitem "
    "WHERE l_shipdate BETWEEN 100 AND 1500 AND l_quantity < 24 "
    "ERROR 5% CONFIDENCE 95%",
    # q1-family grouped multi-aggregate
    "SELECT COUNT(*) AS n, AVG(l_quantity) AS aq FROM lineitem "
    "GROUP BY l_returnflag ERROR 8% CONFIDENCE 90%",
    # ratio composite
    "SELECT SUM(l_extendedprice * l_discount) / SUM(l_extendedprice) AS r "
    "FROM lineitem ERROR 8% CONFIDENCE 90%",
    # PK-FK join
    "SELECT SUM(l_extendedprice) AS rev FROM lineitem "
    "JOIN orders ON l_orderkey = o_orderkey WHERE o_orderdate < 1200 "
    "ERROR 8% CONFIDENCE 90%",
    # exact (no ERROR clause)
    "SELECT SUM(l_quantity) AS q FROM lineitem WHERE l_quantity < 10",
]

HERD = ("SELECT SUM(l_extendedprice * l_discount) AS rev FROM lineitem "
        "WHERE l_quantity < {cap} ERROR 6% CONFIDENCE 90%")


def _run_suite(catalog, shards, pilot_workers=0, ref=False):
    if ref:
        session = ref_api.Session(seed=SEED, config=ref_api.SessionConfig(
            large_table_rows=10_000, pilot_workers=pilot_workers, kernel_mode="xla"))
    else:
        session = Session(seed=SEED, device="cpu", config=SessionConfig(
            large_table_rows=10_000, pilot_workers=pilot_workers))
    session.register_table("orders", catalog["orders"])
    session.register_table("lineitem", catalog["lineitem"], shards=shards)

    # one drain: the suite + a shared-pilot herd (verbatim re-issues share
    # ONE pilot, constant-varied members each pilot their own constant)
    sqls = list(SUITE)
    sqls += [HERD.format(cap=24)] * 3
    sqls += [HERD.format(cap=18 + 2 * i) for i in range(3)]
    handles = [session.submit(q) for q in sqls]
    assert len(session.drain()) == len(handles)
    drain1 = session.scheduler.last_drain

    # result-cache re-issue: identical resubmission answers from the cache
    reissue = session.submit(SUITE[0])
    session.drain()
    assert reissue.cached

    out = {
        "values": [np.asarray(h.result().values) for h in handles],
        "present": [np.asarray(h.result().group_present) for h in handles],
        "fallbacks": [h.fallback for h in handles],
        "reissue": np.asarray(reissue.result().values),
        "pilots_run": session.executor.pilots_run,
        "drain1": drain1,
        "shard_bytes": session.executor.shard_scan_info(),
    }
    session.close()
    return out


@pytest.fixture(scope="module")
def suite_runs(catalogs):
    ref_cat, catalog = catalogs
    runs = {n: _run_suite(catalog, n) for n in (1, 2, 4)}
    runs["ref"] = _run_suite(ref_cat, 2, ref=True)
    return runs


@pytest.mark.parametrize("shards", [2, 4])
def test_suite_bit_identical_to_single_shard(suite_runs, shards):
    base, run = suite_runs[1], suite_runs[shards]
    for vb, vr in zip(base["values"], run["values"]):
        assert_bitwise(vb, vr)
    for pb, pr in zip(base["present"], run["present"]):
        np.testing.assert_array_equal(pb, pr)
    assert base["fallbacks"] == run["fallbacks"]
    assert_bitwise(base["reissue"], run["reissue"])


def test_suite_matches_the_reference(suite_runs):
    mine, theirs = suite_runs[2], suite_runs["ref"]
    assert mine["fallbacks"] == theirs["fallbacks"]
    assert mine["pilots_run"] == theirs["pilots_run"]
    assert mine["shard_bytes"] == theirs["shard_bytes"]
    for a, b in zip(mine["values"], theirs["values"]):
        np.testing.assert_allclose(a, b, rtol=1e-5)
    for a, b in zip(mine["present"], theirs["present"]):
        np.testing.assert_array_equal(a, b)


def test_suite_shares_pilots_identically(suite_runs):
    """The shared-pilot herd runs the same number of pilot stages at every
    shard count (sharing keys are content-derived, not placement-derived)."""
    counts = {n: suite_runs[n]["pilots_run"] for n in (1, 2, 4)}
    assert counts[2] == counts[1] and counts[4] == counts[1]
    # 3 verbatim herd members shared ONE pilot: stages < approximate queries
    approx = sum(1 for s in SUITE if "ERROR" in s) + 6
    assert counts[1] < approx


def test_suite_shard_bytes_attribution(suite_runs):
    for n in (1, 2, 4):
        assert len(suite_runs[n]["shard_bytes"]["lineitem"]) == n
    assert (sum(suite_runs[2]["shard_bytes"]["lineitem"])
            == sum(suite_runs[1]["shard_bytes"]["lineitem"]))
    assert (sum(suite_runs[4]["shard_bytes"]["lineitem"])
            == sum(suite_runs[1]["shard_bytes"]["lineitem"]))


def test_drain_records_pilot_fanout(catalog):
    """With a pilot pool the constant-varied herd's pilot subgroups fan out
    (>= 2 pilot subgroups in one drain group) and the drain surfaces the
    wall / serial accounting.  (The port's pilot pool is off by default,
    ``pilot_workers=0``; the reference sizes it from the cores.)"""
    drain = _run_suite(catalog, 1, pilot_workers=2)["drain1"]
    assert drain.pilot_fanouts >= 1
    assert drain.pilot_fanout_serial_s > 0.0
    assert drain.pilot_fanout_wall_s > 0.0


def test_pilot_fanout_serial_and_concurrent_bit_identical(catalog, suite_runs):
    serial = suite_runs[2]
    conc = _run_suite(catalog, 2, pilot_workers=2)
    for vs, vc in zip(serial["values"], conc["values"]):
        assert_bitwise(vs, vc)
    assert serial["pilots_run"] == conc["pilots_run"]


def test_session_rejects_shards_on_custom_executor(catalog):
    session = Session(executor=Executor(dict(catalog), device="cpu"))
    with pytest.raises(ValueError):
        session.register_table("lineitem", catalog["lineitem"], shards=2)
    session.close()
    with pytest.raises(ValueError):
        Session(dict(catalog), executor=Executor(dict(catalog), device="cpu"))


def test_rejected_shard_count_leaves_session_state_untouched(catalog):
    """An invalid shards= value is rejected BEFORE the table-generation
    bump: cached answers survive and nothing is invalidated over data that
    never changed."""
    session = Session(seed=SEED, device="cpu",
                      config=SessionConfig(large_table_rows=10_000))
    session.register_table("lineitem", catalog["lineitem"], shards=2)
    session.sql(SUITE[0])
    for bad in (0, -1, catalog["lineitem"].num_blocks + 1):
        with pytest.raises(ValueError, match="shards"):
            session.register_table("lineitem", catalog["lineitem"], shards=bad)
    assert session.sql(SUITE[0]).cached  # the failed registrations evicted nothing
    session.close()


def test_register_table_replacement_invalidates_sharded_cache(catalog):
    session = Session(seed=SEED, device="cpu",
                      config=SessionConfig(large_table_rows=10_000))
    session.register_table("lineitem", catalog["lineitem"], shards=2)
    h1 = session.sql(SUITE[0])
    assert session.sql(SUITE[0]).cached
    session.register_table("lineitem", catalog["lineitem"], shards=4)
    h3 = session.sql(SUITE[0])
    assert not h3.cached  # replacement evicted the entry
    assert_bitwise(h3.result().values, h1.result().values)
    session.close()


def test_hand_built_query_dist_matches_plain_session(catalog):
    """Builder / hand-built paths route through the same dist executor."""
    q = Query(child=t_L.Filter(t_L.Scan("lineitem"), t_expr.Col("l_quantity") < 30),
              aggs=(CompositeAgg("q", "sum", t_expr.Col("l_quantity")),))
    spec = ErrorSpec(error=0.06, confidence=0.9)
    vals = {}
    for shards in (1, 2, 4):
        s = Session(seed=SEED, device="cpu",
                    config=SessionConfig(large_table_rows=10_000))
        s.register_table("lineitem", catalog["lineitem"], shards=shards)
        vals[shards] = s.execute(q, spec).result().values
        s.close()
    assert_bitwise(vals[2], vals[1])
    assert_bitwise(vals[4], vals[1])
