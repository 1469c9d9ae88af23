"""Builds shared between a ``DistExecutor``'s shard compilers
(``repro_torch.engine.physical.SharedBuildStore``) against the reference's,
on the CPU.

Both packages shard ``tpch_catalog(24_000, 64, seed=3)`` (the port's copy
built from the same numpy seed) into 4 block ranges and answer the same
sampled finals and pilots; the reference runs its ``xla`` route.  Same-
geometry shards adopt each other's builds, so ``shared_hits``, ``hits`` and
``misses`` must equal the reference's.  Inside the port, sharing changes
builds, never answers: the same session with the store off answers bitwise
the same, and an adopted build reads the tensors of the shard that adopted
it, not those of the shard that built it.
"""

import dataclasses

import numpy as np
import pytest

import repro.engine.expr as r_expr
import repro.engine.logical as r_L
from repro.dist import DistExecutor as RefDistExecutor
from repro.engine.datagen import tpch_catalog as ref_tpch_catalog
import repro_torch.engine.expr as t_expr
import repro_torch.engine.logical as t_L
from repro_torch.dist import DistExecutor, shard_block_ids
from repro_torch.engine.datagen import tpch_catalog
from repro_torch.engine.physical import SharedBuildStore

ROWS, BLOCK_ROWS, SHARDS = 24_000, 64, 4


@pytest.fixture(scope="module")
def catalogs():
    return (ref_tpch_catalog(ROWS, BLOCK_ROWS, seed=3),
            tpch_catalog(ROWS, BLOCK_ROWS, seed=3, device="cpu"))


def _plans(L, E):
    """(kind, plan, seed, rate): Q6 finals (constant-varied), a grouped
    final, SUM/COUNT finals, and pilots of Q6 and of the grouped plan."""
    q6 = lambda c: L.Aggregate(
        child=L.Filter(L.Scan("lineitem"),
                       E.And(E.Col("l_shipdate").between(100, 1500),
                             E.Col("l_quantity") < c)),
        aggs=(L.AggSpec("sum", E.Col("l_extendedprice") * E.Col("l_discount"), "rev"),
              L.AggSpec("count", None, "n")))
    grouped = L.Aggregate(child=L.Scan("lineitem"),
                          aggs=(L.AggSpec("sum", E.Col("l_quantity"), "q"),
                                L.AggSpec("count", None, "n")),
                          group_by="l_returnflag", max_groups=3)
    sum_count = L.Aggregate(child=L.Scan("lineitem"),
                            aggs=(L.AggSpec("sum", E.Col("l_extendedprice"), "s"),
                                  L.AggSpec("count", None, "n")))
    sample = lambda p, seed, rate: L.rewrite_scans(
        p, {"lineitem": L.SampleClause("block", rate, seed)})
    return ([("final", sample(q6(c), 5 + i, 0.2)) for i, c in enumerate((18, 24, 30))]
            + [("final", sample(grouped, 9, 0.2)), ("final", sample(sum_count, 11, 0.3)),
               ("final", sample(sum_count, 12, 0.3)),
               ("pilot", q6(24)), ("pilot", grouped)])


def _run(ex, L, E):
    out = []
    for i, (kind, plan) in enumerate(_plans(L, E)):
        if kind == "final":
            out.append(np.asarray(ex.execute(plan).values, np.float64))
        else:
            out.append(np.asarray(ex.execute_pilot(plan, "lineitem", 0.15, 40 + i)
                                  .block_sums, np.float64))
    return out


def _port(catalog, share=True):
    ex = DistExecutor(dict(catalog), device="cpu")
    if not share:
        ex._shared_builds = None          # each shard builds its own
    ex.register_sharded("lineitem", catalog["lineitem"], SHARDS)
    return ex


def test_shared_hits_match_the_reference(catalogs):
    ref_cat, catalog = catalogs
    rex = RefDistExecutor(dict(ref_cat), kernel_mode="xla")
    rex.register_sharded("lineitem", ref_cat["lineitem"], SHARDS)
    tex = _port(catalog)
    rout, tout = _run(rex, r_L, r_expr), _run(tex, t_L, t_expr)
    r, t = rex.compile_cache_info(), tex.compile_cache_info()
    assert t.shared_hits > 0
    assert (t.shared_hits, t.hits, t.misses) == (r.shared_hits, r.hits, r.misses)
    for a, b in zip(tout, rout):
        np.testing.assert_allclose(a, b, rtol=1e-5)


def test_answers_are_bitwise_with_the_store_on_or_off(catalogs):
    _, catalog = catalogs
    shared, alone = _port(catalog), _port(catalog, share=False)
    on, off = _run(shared, t_L, t_expr), _run(alone, t_L, t_expr)
    for a, b in zip(on, off):
        np.testing.assert_array_equal(a.view(np.int64), b.view(np.int64))
    assert shared.compile_cache_info().shared_hits > 0
    assert alone.compile_cache_info().shared_hits == 0
    assert shared.compile_cache_info().misses == alone.compile_cache_info().misses


def test_an_adopted_build_reads_its_own_shards_tensors(catalogs):
    """Shard 0 builds the pilot and a later shard of its geometry adopts
    it.  Doubling that shard's l_extendedprice doubles exactly the pilot
    sums of its blocks, through the adopted build."""
    _, catalog = catalogs
    ex = _port(catalog)
    plan = _plans(t_L, t_expr)[-2][1]          # the Q6 pilot
    before = ex.execute_pilot(plan, "lineitem", 0.3, 3)
    executors = ex._shard_executors["lineitem"]
    adopters = [k for k, e in enumerate(executors) if e.physical.shared_hits]
    assert executors[0].physical.shared_hits == 0 and adopters
    k = adopters[0]
    tab = executors[k].catalog["lineitem"]
    doubled = dict(tab.columns, l_extendedprice=tab.columns["l_extendedprice"] * 2)
    executors[k].register_table("lineitem", dataclasses.replace(tab, columns=doubled))
    hits = ex.compile_cache_info().shared_hits
    after = ex.execute_pilot(plan, "lineitem", 0.3, 3)
    assert ex.compile_cache_info().shared_hits == hits   # no new build
    in_shard = _pilot_blocks_in(ex, 0.3, 3, ex._sharded["lineitem"].shards[k])
    rev = 0                                     # channel of SUM(price * discount)
    np.testing.assert_array_equal(after.block_sums[in_shard, :, rev],
                                  2 * before.block_sums[in_shard, :, rev])
    np.testing.assert_array_equal(after.block_sums[~in_shard],
                                  before.block_sums[~in_shard])
    assert in_shard.any() and (~in_shard).any()


def _pilot_blocks_in(ex, rate, seed, shard):
    """Which rows of a pilot's block sums belong to ``shard``'s blocks."""
    sharded = ex._sharded["lineitem"]
    global_ids, _ = shard_block_ids(sharded.num_blocks, rate, seed, sharded)
    return (global_ids >= shard.start_block) & (global_ids < shard.end_block)


def test_store_adopts_the_first_build_of_a_key():
    store = SharedBuildStore()
    assert store.get(("k",)) is None
    first, second = object(), object()
    store.put(("k",), first)
    store.put(("k",), second)
    assert store.get(("k",)) is first
