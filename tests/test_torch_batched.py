"""The batched kernels and the batched final path of the port, on the CPU.

* The batched plain versions (the CPU route of ``filtered_agg_batched`` and
  ``block_agg_batched``) against the reference's batched Pallas kernels in
  interpret mode: counts exact, sums within rtol 1e-5 (both sides sum a
  block's rows in f32, in different orders), min / max exact.
* Each batched lane bitwise equal to the port's solo call on its row.
* ``Executor.execute_batch`` lanes bitwise equal to ``execute``, as the
  reference pins it (``tests/test_constant_hoisting.py``): one batched miss
  for a power-of-two set, 5 members as 4 + 1, an empty sample surfaced per
  member.
* The thread-safety of the launch counters and of the compile cache.
"""

import os
import sys
import threading

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.block_agg import block_agg_batched as ref_block_agg_batched
from repro.kernels.filtered_agg import \
    filtered_agg_batched as ref_filtered_agg_batched
from repro_torch.engine import logical as L
from repro_torch.engine.datagen import tpch_catalog
from repro_torch.engine.executor import EmptySampleError, Executor
from repro_torch.engine.expr import And, Col
from repro_torch.engine.physical import ScanRuntime, plan_constants
from repro_torch.kernels.block_agg import block_agg, block_agg_batched
from repro_torch.kernels.filtered_agg import filtered_agg, filtered_agg_batched

N_BLOCKS = 24
EMPTY_BLOCK = 3  # every row invalid
# per-lane bounds (lo1, hi1, lo2, hi2, c3); lane 0 sits on the discount
# bounds 0.02 / 0.08, which rows hit exactly
BOUNDS = np.asarray([[100.0, 1500.0, 0.02, 0.08, 24.0],
                     [0.0, 2525.0, 0.05, 0.07, 40.0],
                     [-3e38, 3e38, 0.0, 0.02, 3e38]], np.float32)


def _lineitem_like(block_rows: int, seed: int):
    """Q6-shaped columns: f32 price, discount k/100, int32 shipdate, f32
    quantity; bool valid with one all-invalid block."""
    rng = np.random.default_rng(seed)
    n = N_BLOCKS * block_rows
    price = rng.uniform(900.0, 1100.0, n).astype(np.float32)
    discount = rng.integers(0, 11, n).astype(np.float32) / 100.0
    shipdate = rng.integers(0, 2526, n).astype(np.int32)
    quantity = rng.integers(1, 51, n).astype(np.float32)
    valid = rng.random(n) < 0.9
    valid[EMPTY_BLOCK * block_rows:(EMPTY_BLOCK + 1) * block_rows] = False
    return price, discount, shipdate, quantity, valid


def _ids(seed: int, batch: int = 3) -> np.ndarray:
    """(batch, 16) id rows: repeats, the empty block, zero padding."""
    rng = np.random.default_rng(seed)
    rows = []
    for b in range(batch):
        real = np.concatenate([rng.integers(0, N_BLOCKS, 8 + b),
                               [EMPTY_BLOCK, 5, 5]])
        rows.append(np.concatenate([real, np.zeros(16 - len(real))]))
    return np.asarray(rows, np.int32)


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _bits(t):
    return t.contiguous().view(torch.int32)


@pytest.mark.parametrize("block_rows", [8, 32, 100])
@pytest.mark.parametrize("channel", ["product", "sum", "count"])
def test_filtered_agg_batched_matches_reference(block_rows, channel):
    price, discount, shipdate, quantity, valid = _lineitem_like(block_rows, 1)
    ids = _ids(2)
    if channel == "product":
        x, y, ref_y = price, discount, discount
    elif channel == "sum":
        x, y, ref_y = price, None, np.ones_like(price)
    else:
        x, y, ref_y = shipdate, shipdate, shipdate
    cols = (shipdate, discount, quantity)
    ref = np.asarray(ref_filtered_agg_batched(
        jnp.asarray(x), jnp.asarray(ref_y), *(jnp.asarray(c) for c in cols),
        jnp.asarray(valid), block_rows, jnp.asarray(ids), jnp.asarray(BOUNDS),
        interpret=True))
    args = (_t(x), None if y is None else _t(y), *(_t(c) for c in cols),
            _t(valid), block_rows)
    out = filtered_agg_batched(*args, _t(ids), _t(BOUNDS))
    assert out.shape == (3, ids.shape[1], 3) and out.dtype == torch.float32
    o = out.numpy()
    np.testing.assert_array_equal(o[..., 0], ref[..., 0])
    np.testing.assert_allclose(o[..., 1:], ref[..., 1:], rtol=1e-5)
    assert (o[ids == EMPTY_BLOCK] == 0).all()
    # lane b is bitwise the solo call on its ids and bounds
    for b in range(3):
        solo = filtered_agg(*args, _t(ids[b]), _t(BOUNDS[b]))
        assert torch.equal(_bits(out[b]), _bits(solo))


@pytest.mark.parametrize("block_rows", [8, 32, 100])
@pytest.mark.parametrize("values", ["f32", "int32", "count"])
def test_block_agg_batched_matches_reference(block_rows, values):
    price, _, shipdate, _, valid = _lineitem_like(block_rows, 4)
    ids = _ids(5)
    col = {"f32": price, "int32": shipdate, "count": valid}[values]
    ref = np.asarray(ref_block_agg_batched(
        jnp.asarray(col), jnp.asarray(valid), block_rows, jnp.asarray(ids),
        interpret=True))
    out = block_agg_batched(_t(col), _t(valid), block_rows, _t(ids))
    assert out.shape == (3, ids.shape[1], 5) and out.dtype == torch.float32
    o = out.numpy()
    np.testing.assert_array_equal(o[..., 0], ref[..., 0])
    np.testing.assert_allclose(o[..., 1:3], ref[..., 1:3], rtol=1e-5)
    np.testing.assert_array_equal(o[..., 3:], ref[..., 3:])  # NaN sentinel
    empty = ids == EMPTY_BLOCK
    assert (o[empty][:, :3] == 0).all() and np.isnan(o[empty][:, 3:]).all()
    for b in range(3):
        solo = block_agg(_t(col), _t(valid), block_rows, _t(ids[b]))
        assert torch.equal(_bits(out[b]), _bits(solo))


@pytest.mark.parametrize("bad", ["ids_1d", "bounds_1d", "bounds_rows", "int64_ids"])
def test_batched_wrappers_reject_what_the_kernels_do_not_take(bad):
    price, discount, shipdate, quantity, valid = _lineitem_like(32, 8)
    ids, bounds = _t(_ids(9)), _t(BOUNDS)
    if bad == "ids_1d":
        ids = ids[0].contiguous()
    elif bad == "bounds_1d":
        bounds = bounds[0].contiguous()
    elif bad == "bounds_rows":
        bounds = bounds[:2].contiguous()
    else:
        ids = ids.long()
    with pytest.raises(ValueError):
        filtered_agg_batched(_t(price), None, _t(shipdate), _t(discount),
                             _t(quantity), _t(valid), 32, ids, bounds)
    if bad in ("ids_1d", "int64_ids"):
        with pytest.raises(ValueError):
            block_agg_batched(_t(price), _t(valid), 32, ids)


@pytest.mark.parametrize("wrapper", ["filtered_agg", "filtered_agg_batched",
                                     "block_agg", "block_agg_batched"])
def test_counters_keep_every_update_across_threads(wrapper):
    """Drain workers call the wrappers from several threads: every call is
    counted (the counters are bumped under a lock)."""
    price, discount, shipdate, quantity, valid = _lineitem_like(8, 10)
    ids = _t(_ids(11, batch=2))
    args = {
        "filtered_agg": (filtered_agg, (_t(price), None, _t(shipdate),
                                        _t(discount), _t(quantity), _t(valid),
                                        8, ids[0], _t(BOUNDS[0]))),
        "filtered_agg_batched": (filtered_agg_batched, (
            _t(price), None, _t(shipdate), _t(discount), _t(quantity),
            _t(valid), 8, ids, _t(BOUNDS[:2]))),
        "block_agg": (block_agg, (_t(price), _t(valid), 8, ids[0])),
        "block_agg_batched": (block_agg_batched, (_t(price), _t(valid), 8, ids)),
    }
    fn, a = args[wrapper]
    before = fn.calls
    threads, per = 2 * (os.cpu_count() or 1) + 2, 25

    def work():
        for _ in range(per):
            fn(*a)

    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)   # switch threads as often as possible
    try:
        ts = [threading.Thread(target=work) for _ in range(threads)]
        for t in ts:
            t.start()
        for t in ts:
            t.join(timeout=120)
    finally:
        sys.setswitchinterval(interval)
    assert not any(t.is_alive() for t in ts)
    assert fn.calls - before == threads * per


# -- the executor's batched final path ---------------------------------------

@pytest.fixture(scope="module")
def catalog():
    return tpch_catalog(6_000, 32, seed=0, device="cpu")


def _q6_plan(lo, hi, cap):
    pred = And(Col("l_shipdate").between(lo, hi), Col("l_quantity") < cap)
    return L.Aggregate(
        child=L.Filter(L.Scan("lineitem"), pred),
        aggs=(L.AggSpec("sum", Col("l_extendedprice") * Col("l_discount"), "rev"),
              L.AggSpec("count", None, "cnt")))


def _plain_plan():
    return L.Aggregate(
        child=L.Scan("lineitem"),
        aggs=(L.AggSpec("sum", Col("l_extendedprice"), "rev"),
              L.AggSpec("count", None, "cnt")))


def _plans(shape: str, n: int):
    def one(i):
        base = (_q6_plan(100 + 10 * i, 1600, 20 + i) if shape == "filtered"
                else _plain_plan())
        return L.rewrite_scans(
            base, {"lineitem": L.SampleClause("block", 0.3, seed=i)})
    return [one(i) for i in range(n)]


@pytest.mark.parametrize("shape,route", [("filtered", "filtered_agg_batched"),
                                         ("block", "block_agg_batched")])
def test_execute_batch_lanes_bitwise_match_solo(catalog, shape, route):
    ex_batch = Executor(catalog, device="cpu")
    ex_solo = Executor(catalog, device="cpu")
    calls = filtered_agg_batched.calls, block_agg_batched.calls
    outs = ex_batch.execute_batch(_plans(shape, 4))
    for plan, out in zip(_plans(shape, 4), outs):
        ref = ex_solo.execute(plan)
        np.testing.assert_array_equal(out.values, ref.values)
        np.testing.assert_array_equal(out.raw_sums, ref.raw_sums)
        np.testing.assert_array_equal(out.group_counts, ref.group_counts)
        assert out.scanned_bytes == ref.scanned_bytes
        for t, info in out.sample_infos.items():
            np.testing.assert_array_equal(
                info.sampled_block_ids, ref.sample_infos[t].sampled_block_ids)
    # one batch-of-4 callable for the pow2 set, one batched call
    info = ex_batch.compile_cache_info()
    assert info.misses == info.batched_misses == 1, info
    assert {c.route for c in ex_batch.physical._cache.values()} == {route}
    moved = (filtered_agg_batched.calls - calls[0],
             block_agg_batched.calls - calls[1])
    assert moved == ((1, 0) if shape == "filtered" else (0, 1))
    assert ex_batch.queries_run == 4

    # 5 members run as 4 + 1: the 4-lane callable is reused, the fifth runs
    # solo on its drawn sample
    m0 = ex_batch.compile_cache_info()
    outs5 = ex_batch.execute_batch(_plans(shape, 5))
    for plan, out in zip(_plans(shape, 5), outs5):
        np.testing.assert_array_equal(out.values, ex_solo.execute(plan).values)
    m1 = ex_batch.compile_cache_info()
    assert (m1.misses - m0.misses, m1.batched_hits - m0.batched_hits) == (1, 1)
    assert ex_batch.queries_run == 9


def test_execute_batch_surfaces_empty_samples_per_member(catalog):
    ex = Executor(catalog, device="cpu")
    good = L.rewrite_scans(_q6_plan(100, 1500, 24),
                           {"lineitem": L.SampleClause("block", 0.4, seed=1)})
    empty = L.rewrite_scans(_q6_plan(100, 1500, 24),
                            {"lineitem": L.SampleClause("block", 1e-9, seed=1)})
    landed = []
    outs = ex.execute_batch([good, empty, good],
                            on_result=lambda i, r: landed.append(i))
    assert isinstance(outs[1], EmptySampleError)
    ref = Executor(catalog, device="cpu").execute(good)
    np.testing.assert_array_equal(outs[0].values, ref.values)
    np.testing.assert_array_equal(outs[2].values, ref.values)
    assert sorted(landed) == [0, 1, 2]


def test_execute_batch_runs_unsampled_members_solo(catalog):
    """A final at rate 1 has no sampled scan: it runs its exact scan solo,
    beside a batched pair."""
    ex = Executor(catalog, device="cpu")
    plans = _plans("filtered", 2) + [_q6_plan(100, 1500, 24)]
    outs = ex.execute_batch(plans)
    np.testing.assert_array_equal(
        outs[2].values, Executor(catalog, device="cpu").execute(plans[2]).values)
    assert ex.compile_cache_info().batched_misses == 1


def test_call_batch_range_checks_ids_on_the_host(catalog):
    ex = Executor(catalog, device="cpu")
    plan = _plans("block", 1)[0]
    nb = catalog["lineitem"].num_blocks
    good = ScanRuntime("block", 2, 64, np.zeros(64, np.int32))
    bad_ids = np.zeros(64, np.int32)
    bad_ids[3] = nb
    bad = ScanRuntime("block", 2, 64, bad_ids)
    compiled = ex.physical.compile_batched_query(plan, {"lineitem": good}, 2)
    with pytest.raises(ValueError, match="block ids"):
        compiled.call_batch([{"lineitem": good}, {"lineitem": bad}], [[], []])
    with pytest.raises(ValueError, match="batch callable"):
        compiled.call_batch([{"lineitem": good}], [[]])


def test_compile_cache_builds_a_key_once_across_threads(catalog):
    """Threads asking for one key together: one build, one miss, the rest
    hits that wait for it (the reference's Future placeholder)."""
    ex = Executor(catalog, device="cpu")
    plan = _plans("filtered", 1)[0]
    rt = ScanRuntime("block", 2, 64, np.zeros(64, np.int32))
    builds = []
    start = threading.Barrier(8)
    build = ex.physical._build_batched

    def slow_build(*a):
        builds.append(1)
        threading.Event().wait(0.05)
        return build(*a)

    ex.physical._build_batched = slow_build
    got = []

    def work():
        start.wait()
        got.append(ex.physical.compile_batched_query(plan, {"lineitem": rt}, 2))

    ts = [threading.Thread(target=work) for _ in range(8)]
    for t in ts:
        t.start()
    for t in ts:
        t.join(timeout=120)
    assert not any(t.is_alive() for t in ts)
    info = ex.compile_cache_info()
    assert len(builds) == 1 and (info.misses, info.hits) == (1, 7)
    assert (info.batched_misses, info.batched_hits, info.size) == (1, 7, 1)
    assert all(g is got[0] for g in got)


def test_a_failed_build_is_retried(catalog):
    """A build that raises leaves no cache entry, so the next call builds
    again; here the filterless SUM(a - b) the kernels cannot take, whose
    batch runs each lane through the solo gather body."""
    ex = Executor(catalog, device="cpu")
    plan = L.rewrite_scans(
        L.Aggregate(child=L.Scan("lineitem"),
                    aggs=(L.AggSpec("sum", Col("l_extendedprice") - Col("l_discount"),
                                    "x"),)),
        {"lineitem": L.SampleClause("block", 0.3, seed=1)})
    rt = ScanRuntime("block", 2, 64, np.zeros(64, np.int32))
    build = ex.physical._build_batched

    def failing(*a):
        raise RuntimeError("build failed")

    ex.physical._build_batched = failing
    for _ in range(2):
        with pytest.raises(RuntimeError, match="build failed"):
            ex.physical.compile_batched_query(plan, {"lineitem": rt}, 2)
    info = ex.compile_cache_info()
    assert (info.misses, info.size) == (2, 0)
    ex.physical._build_batched = build
    compiled = ex.physical.compile_batched_query(plan, {"lineitem": rt}, 2)
    info = ex.compile_cache_info()
    assert (info.misses, info.size, compiled.route) == (3, 1, "gather_batched")
    rt2 = ScanRuntime("block", 3, 64, np.arange(64, dtype=np.int32))
    sums, counts = compiled.call_batch([{"lineitem": rt}, {"lineitem": rt2}],
                                       [plan_constants(plan)] * 2)
    for k, r in enumerate((rt, rt2)):
        s1, c1 = ex.physical.compile_query(plan, {"lineitem": r})(
            {"lineitem": r}, plan_constants(plan))
        assert torch.equal(sums[k], s1) and torch.equal(counts[k], c1)
