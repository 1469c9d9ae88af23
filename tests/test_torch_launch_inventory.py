"""The launch inventory of ``docs/torch_execution.md``, measured on the CPU.

Each route of the port answers the same queries over ``tpch_catalog(
2_000_000, 32, seed=0)`` at ``ERROR 10% CONFIDENCE 95%`` (no fallback at
this size), and the kernel wrappers' ``calls`` counters (the CPU runs each
wrapper's plain version; on the card ``launches`` counts the same calls,
one launch each) and ``Executor.device_dispatches`` are read per query.
The counts asserted here are the doc's table, route by route.
"""

import pytest

from repro_torch.api import Session, SessionConfig
from repro_torch.engine.datagen import tpch_catalog
from repro_torch.engine.executor import Executor
from repro_torch.kernels.block_agg import block_agg, block_agg_batched
from repro_torch.kernels.filtered_agg import filtered_agg, filtered_agg_batched
from repro_torch.kernels.segment_sum import segment_sum
from repro_torch.kernels.taqa_solve import taqa_draw_compact, taqa_solve_rate

WRAPPERS = (filtered_agg, filtered_agg_batched, block_agg, block_agg_batched,
            segment_sum, taqa_solve_rate, taqa_draw_compact)
GUARANTEE = " ERROR 10% CONFIDENCE 95%"
QUERIES = {
    "q6": ("SELECT SUM(l_extendedprice * l_discount) AS revenue FROM lineitem "
           "WHERE l_shipdate BETWEEN 100 AND 1500 AND l_discount BETWEEN 0.02 AND 0.08"),
    "sum_count": "SELECT SUM(l_extendedprice) AS s, COUNT(*) AS n FROM lineitem",
    "q1": ("SELECT SUM(l_quantity) AS q, COUNT(*) AS n FROM lineitem "
           "WHERE l_shipdate < 2000 GROUP BY l_returnflag"),
    "join": ("SELECT SUM(l_extendedprice) AS rev FROM lineitem JOIN orders "
             "ON l_orderkey = o_orderkey WHERE o_orderdate < 1200"),
}
HERD = ([f"SELECT SUM(l_extendedprice * l_discount) AS revenue FROM lineitem "
         f"WHERE l_shipdate BETWEEN {100 + 50 * i} AND {1500 + 30 * i} AND "
         f"l_discount BETWEEN 0.02 AND 0.08" + GUARANTEE for i in range(8)]
        + [QUERIES["sum_count"] + f" ERROR {e}% CONFIDENCE 95%" for e in (5, 6, 7, 8)])

# (route, query) -> (calls by wrapper, device dispatches or None where the
# route does not count them); docs/torch_execution.md's table
SOLO = {
    ("compiled", "q6"): ({"filtered_agg": 2}, 2),
    ("compiled", "sum_count"): ({"block_agg": 2}, 2),
    ("compiled", "q1"): ({"segment_sum": 2}, 2),
    ("compiled", "join"): ({"segment_sum": 3}, 2),
    ("eager", "q6"): ({"segment_sum": 2}, 0),
    ("eager", "sum_count"): ({"segment_sum": 2}, 0),
    ("eager", "q1"): ({"segment_sum": 2}, 0),
    ("eager", "join"): ({"segment_sum": 3}, 0),
    ("fused", "q6"): ({"filtered_agg": 2, "taqa_solve_rate": 1, "taqa_draw_compact": 1}, 1),
    ("fused", "sum_count"): ({"block_agg": 2, "taqa_solve_rate": 1, "taqa_draw_compact": 1}, 1),
    ("fused", "q1"): ({"segment_sum": 2}, 2),      # grouped: not fused
    ("staged", "q6"): ({"filtered_agg": 2}, 2),
    ("staged", "sum_count"): ({"block_agg": 2}, 2),
    ("staged", "q1"): ({"segment_sum": 2}, 2),
    ("dist4", "q6"): ({"filtered_agg": 8}, None),
    ("dist4", "sum_count"): ({"block_agg": 8}, None),
    ("dist4", "q1"): ({"segment_sum": 8}, None),
    ("dist4", "join"): ({"segment_sum": 12}, None),
    ("dist4_staged", "q6"): ({"filtered_agg": 8}, None),
    ("dist4_staged", "q1"): ({"segment_sum": 8}, None),
}
DRAIN = {
    "drain": {"filtered_agg_batched": 3, "filtered_agg": 2, "block_agg": 3,
              "block_agg_batched": 1},
    "drain_dist4": {"filtered_agg": 64, "block_agg": 20},
}


@pytest.fixture(scope="module")
def catalog():
    return tpch_catalog(2_000_000, 32, seed=0, device="cpu")


def _zero():
    for w in WRAPPERS:
        w.calls = 0


def _calls():
    return {w.__name__: w.calls for w in WRAPPERS if w.calls}


def _session(catalog, route):
    cfg = SessionConfig(result_cache_size=0, async_workers=0,
                        fused_taqa=route == "fused")
    if route == "eager":
        return Session(executor=Executor(dict(catalog), device="cpu", use_compiled=False),
                       seed=3, config=cfg)
    s = Session(catalog, seed=3, device="cpu", config=cfg)
    kw = {"staged": {"staged_rates": True}, "dist4": {"shards": 4},
          "dist4_staged": {"shards": 4, "staged_rates": True},
          "drain_dist4": {"shards": 4}}.get(route)
    if kw:
        s.register_table("lineitem", catalog["lineitem"], **kw)
    return s


@pytest.mark.parametrize("route,query", sorted(SOLO))
def test_launches_per_query_equal_the_doc(catalog, route, query):
    want_calls, want_dispatches = SOLO[(route, query)]
    s = _session(catalog, route)
    try:
        _zero()
        d0 = s.executor.device_dispatches
        h = s.sql(QUERIES[query] + GUARANTEE)
        assert h.status == "done" and h.fallback is None, (h.error, h.fallback)
        assert _calls() == want_calls
        if want_dispatches is not None:
            assert s.executor.device_dispatches - d0 == want_dispatches
    finally:
        s.close()


@pytest.mark.parametrize("route", sorted(DRAIN))
def test_launches_per_drain_equal_the_doc(catalog, route):
    s = _session(catalog, route)
    try:
        _zero()
        hs = [s.submit(q) for q in HERD]
        s.drain()
        assert all(h.status == "done" for h in hs)
        assert _calls() == DRAIN[route]
        assert s.scheduler.last_drain.pilots_run == 9
    finally:
        s.close()


def test_a_stacked_pilot_is_one_call_a_group(catalog):
    """``run_pilots_batched`` over four Q6 windows and three grouped Q1s:
    one ``filtered_agg_batched`` call and one ``segment_sum`` call (the
    gather stack), one dispatch each."""
    s = _session(catalog, "compiled")
    try:
        hs = [s.prepare(f"SELECT SUM(l_extendedprice * l_discount) AS revenue FROM lineitem "
                        f"WHERE l_shipdate BETWEEN {100 + 50 * i} AND {1500 + 30 * i} "
                        f"AND l_discount BETWEEN 0.02 AND 0.08" + GUARANTEE) for i in range(4)]
        hs += [s.prepare(f"SELECT SUM(l_quantity) AS q FROM lineitem WHERE l_shipdate "
                         f"< {1800 + 100 * i} GROUP BY l_returnflag" + GUARANTEE)
               for i in range(3)]
        _zero()
        d0 = s.executor.device_dispatches
        out = s.db.run_pilots_batched([(h.query, h.spec, 11 + i) for i, h in enumerate(hs)])
        assert not any(isinstance(o, Exception) for o in out)
        assert _calls() == {"filtered_agg_batched": 1, "segment_sum": 1}
        assert s.executor.device_dispatches - d0 == 2
    finally:
        s.close()
