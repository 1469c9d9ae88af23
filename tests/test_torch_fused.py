"""The port's fused single-launch TAQA path on the CPU, against its own
two-stage path and against the reference's fused path.

Inside the port the contract is bitwise: for every cell of the reference's
matrix — solo, constant-varied herd, cached re-issue, staged ladder, 1-shard
and 2-shard registrations — ``fused_taqa=True`` delivers answers
``np.array_equal`` to ``fused_taqa=False`` (the same content-derived draws
through the same solo pilot and final bodies; the device's final draw is
verified against the host's before its sums are used).  Sharded pilot tables
are outside the fused envelope, so both sessions run two stages there.

Against the reference's ``run_fused`` (its ``xla`` route, on the CPU), both
packages building ``tpch_catalog(600_000, 32, seed=0)`` from one numpy seed:
the pilot and final block ids, nsel and flags exactly, rates within rtol
1e-6, answers within rtol 1e-5, and the device's f32 theta within
:func:`theta_rtol` — rtol 1e-5 where the f32 variance is well conditioned,
wider where its ``s2 - s1 * s1 / n`` cancels digits (the two packages add
s1 and s2 in different orders).
"""

import dataclasses as dc

import numpy as np
import pytest
import torch

import repro.engine.expr as r_expr
import repro.engine.logical as r_L
from repro.core import CompositeAgg as RefCompositeAgg
from repro.core import ErrorSpec as RefErrorSpec
from repro.core import PilotDB as RefPilotDB
from repro.core import Query as RefQuery
from repro.engine.datagen import tpch_catalog as ref_tpch_catalog
from repro.engine.executor import Executor as RefExecutor
import repro_torch.engine.expr as t_expr
import repro_torch.engine.logical as t_L
from repro_torch.api import Session, SessionConfig
from repro_torch.core import CompositeAgg, ErrorSpec, PilotDB, Query
from repro_torch.engine import physical
from repro_torch.engine.datagen import tpch_catalog
from repro_torch.engine.executor import Executor
from repro_torch.engine.sampling import draw_block_ids, pad_block_ids
from repro_torch.kernels.taqa_solve import (taqa_draw_compact, taqa_draw_compact_ref,
                                            taqa_solve_rate, taqa_solve_rate_ref)
from repro_torch.kernels.taqa_solve import ref as solve_ref

BASE = SessionConfig(async_workers=0)
FUSED = dc.replace(BASE, fused_taqa=True)

SQL = ("SELECT SUM(l_extendedprice * l_discount) AS rev FROM lineitem "
       "WHERE l_shipdate BETWEEN 100 AND 1500 "
       "AND l_discount BETWEEN 0.02 AND 0.08 AND l_quantity < 24 "
       "ERROR 8% CONFIDENCE 95%")
HERD = [SQL.replace("BETWEEN 100 AND 1500", f"BETWEEN 100 AND {1500 + 40 * i}")
        for i in range(4)]
SUM_COUNT = ("SELECT SUM(l_extendedprice) AS s, COUNT(*) AS n FROM lineitem "
             "ERROR 5% CONFIDENCE 95%")
SPEC = dict(error=0.08, confidence=0.95)


@pytest.fixture(scope="module")
def catalogs():
    return (ref_tpch_catalog(scale_rows=600_000, block_rows=32, seed=0),
            tpch_catalog(scale_rows=600_000, block_rows=32, seed=0, device="cpu"))


@pytest.fixture(scope="module")
def catalog(catalogs):
    return catalogs[1]


def q6(L, E, Q, C):
    pred = E.And(E.Col("l_shipdate").between(100, 1500),
                 E.And(E.Col("l_discount").between(0.02, 0.08),
                       E.Col("l_quantity") < 24))
    return Q(child=L.Filter(L.Scan("lineitem"), pred),
             aggs=(C("revenue", "sum", E.Col("l_extendedprice") * E.Col("l_discount")),))


def sum_count(L, E, Q, C):
    return Q(child=L.Scan("lineitem"),
             aggs=(C("s", "sum", E.Col("l_extendedprice")), C("n", "count", None)))


def sum_or(L, E, Q, C):
    """A SUM under an OR predicate, which the column kernels cannot take:
    the gather route."""
    pred = E.Or(E.Col("l_quantity") < 25, E.Col("l_discount") > 0.05)
    return Q(child=L.Filter(L.Scan("lineitem"), pred),
             aggs=(C("s", "sum", E.Col("l_extendedprice")),))


def ratio(L, E, Q, C):
    """A ratio of two filterless sums, one a product: two solve channels on
    the gather route."""
    return Q(child=L.Scan("lineitem"),
             aggs=(C("r", "ratio", E.Col("l_extendedprice") * E.Col("l_discount"),
                     E.Col("l_extendedprice")),))


def port_q(shape):
    return shape(t_L, t_expr, Query, CompositeAgg)


def ref_q(shape):
    return shape(r_L, r_expr, RefQuery, RefCompositeAgg)


def _run(catalog, cfg, sqls, *, shards=None, staged=None, sequential=False):
    s = Session(seed=11, config=cfg, device="cpu")
    for name, tab in catalog.items():
        s.register_table(name, tab,
                         shards=shards if name == "lineitem" else None,
                         staged_rates=staged if name == "lineitem" else None)
    if sequential:  # drain each query on its own (the cached re-issue shape)
        handles = []
        for q in sqls:
            handles.append(s.submit(q))
            s.drain()
    else:
        handles = [s.submit(q) for q in sqls]
        s.drain()
    vals = []
    for h in handles:
        assert h.status == "done", h.error
        vals.append(h.result().values)
    info = s.compile_cache_info()
    fused = [h._fused for h in handles]
    s.close()
    return vals, info, fused


MATRIX = {
    "solo": dict(sqls=[SQL]),
    "herd": dict(sqls=HERD),
    # sequential re-issue: the second drain answers from the result cache
    # (a fused-computed entry must rebuild the identical answer)
    "cached": dict(sqls=[SQL, SQL], sequential=True),
    "staged": dict(sqls=[SQL], staged=True),
    "shard1": dict(sqls=[SQL], shards=1),
    "shard2": dict(sqls=[SQL], shards=2),
}


@pytest.mark.parametrize("cell", list(MATRIX))
def test_fused_bitwise_matrix(catalog, cell):
    kw = dict(MATRIX[cell])
    sqls = kw.pop("sqls")
    base_vals, _, base_fused = _run(catalog, BASE, sqls, **kw)
    fused_vals, info, fused = _run(catalog, FUSED, sqls, **kw)
    assert not any(base_fused)
    for a, b in zip(base_vals, fused_vals):
        np.testing.assert_array_equal(a, b)
    engaged = info.fused_hits + info.fused_misses
    if cell in ("shard1", "shard2"):
        # sharded pilot tables are outside the fused envelope: the fused
        # session ran the two-stage path
        assert engaged == 0 and not any(fused), info
    else:
        assert engaged >= 1 and fused[0], info


def test_fused_through_sql_is_bitwise(catalog):
    """Session.sql takes the fused branch of _run_handle (the drain takes
    _try_fused): Q6 and SUM/COUNT bitwise the two-stage answers."""
    out = {}
    for cfg in (BASE, FUSED):
        s = Session(catalog, seed=5, device="cpu", config=cfg)
        hs = [s.sql(SQL), s.sql(SUM_COUNT)]
        assert all(h.status == "done" for h in hs), [h.error for h in hs]
        out[cfg.fused_taqa] = ([h.answer.values for h in hs], [h._fused for h in hs],
                               s.executor.device_dispatches)
        s.close()
    for a, b in zip(out[False][0], out[True][0]):
        np.testing.assert_array_equal(a, b)
    assert out[True][1] == [True, True] and out[False][1] == [False, False]
    assert out[True][2] < out[False][2]


@pytest.mark.parametrize("seed", range(4))
def test_run_fused_is_one_dispatch_and_bitwise(catalog, seed):
    """PilotDB-level pinning: the fused program answers in exactly ONE
    dispatch (two-stage: pilot + final), with values, report statistics and
    scanned-bytes attribution bitwise equal."""
    spec = ErrorSpec(**SPEC)
    ex_a, ex_b = Executor(catalog, device="cpu"), Executor(catalog, device="cpu")
    pilots = []
    execute_pilot = ex_a.execute_pilot

    def spy_pilot(*args, **kwargs):
        pilots.append(execute_pilot(*args, **kwargs))
        return pilots[-1]

    ex_a.execute_pilot = spy_pilot
    fused = _spy_fused(ex_b)
    ans_a = PilotDB(ex_a).query(port_q(q6), spec, seed=seed)
    ans_b = PilotDB(ex_b).run_fused(port_q(q6), spec, seed=seed)
    assert ans_b is not None, "fused path did not engage"
    # the fused program's pilot statistics are the two-stage pilot's bits
    (pilot,), (f,) = pilots, fused
    n_real = f["runtimes"]["lineitem"].n_real
    assert pilot.n_sampled_blocks == n_real
    np.testing.assert_array_equal(f["out"]["block_sums"][:n_real], pilot.block_sums)
    np.testing.assert_array_equal(f["out"]["present"], pilot.group_present)
    assert ex_a.device_dispatches >= 2
    assert ex_b.device_dispatches == 1, ex_b.device_dispatches
    assert ex_b.pilots_run == ex_b.queries_run == 1
    np.testing.assert_array_equal(ans_a.values, ans_b.values)
    ra, rb = ans_a.report, ans_b.report
    assert ra.fallback == rb.fallback
    assert ra.theta_pilot == rb.theta_pilot
    assert ra.n_pilot_blocks == rb.n_pilot_blocks
    assert ra.pilot_scanned_bytes == rb.pilot_scanned_bytes
    assert ra.final_scanned_bytes == rb.final_scanned_bytes
    assert dict(ra.plan.rates) == dict(rb.plan.rates)


def test_run_fused_gates_to_none_outside_envelope(catalog):
    """Ineligible shapes return None BEFORE any device work."""
    spec = ErrorSpec(**SPEC)
    ex = Executor(catalog, device="cpu")
    db = PilotDB(ex)
    grouped = Query(child=t_L.Scan("lineitem"),
                    aggs=(CompositeAgg("qty", "sum", t_expr.Col("l_quantity")),),
                    group_by="l_returnflag", max_groups=3)
    join = Query(child=t_L.Filter(
        t_L.Join(t_L.Scan("lineitem"), t_L.Scan("orders"), "l_orderkey", "o_orderkey"),
        t_expr.Col("o_orderdate") < 1200),
        aggs=(CompositeAgg("rev", "sum", t_expr.Col("l_extendedprice")),))
    calls = taqa_solve_rate.calls, taqa_draw_compact.calls
    assert db.run_fused(grouped, spec, seed=0) is None
    assert db.run_fused(join, spec, seed=0) is None
    assert ex.device_dispatches == 0 and ex.pilots_run == 0
    # eager executors never fuse
    ex_eager = Executor(catalog, device="cpu", use_compiled=False)
    assert PilotDB(ex_eager).run_fused(port_q(q6), spec, seed=0) is None
    assert ex_eager.device_dispatches == 0 and ex_eager.pilots_run == 0
    assert (taqa_solve_rate.calls, taqa_draw_compact.calls) == calls
    assert ex.compile_cache_info().fused_misses == 0


def theta_rtol(out, n_real, channels) -> float:
    """The f32 solve's theta tolerance between two summation orders of s1
    and s2: rtol 1e-6 * max(10, kappa), kappa = s2 / ((n - 1) var) of the f64
    pilot sums, the factor by which ``s2 - s1 * s1 / n`` magnifies the sums'
    f32 rounding (about 5 for Q6's revenue, 110 for SUM(l_extendedprice),
    whose block sums vary little around a large mean; a zero-variance COUNT
    channel binds no rate and is left out)."""
    y = out["block_sums"][:n_real, 0, :][:, list(channels)]
    n = n_real
    s1, s2 = y.sum(axis=0), (y * y).sum(axis=0)
    var = (s2 - s1 * s1 / n) / (n - 1)
    kappa = [a / ((n - 1) * v) for a, v in zip(s2, var) if v > 0]
    return 1e-6 * max([10.0] + kappa)


def _spy_fused(ex):
    """Record each execute_fused call's inputs and host outputs."""
    seen = []
    inner = ex.execute_fused

    def spy(plan, pilot_table, runtimes, solve, scal, u, solve_channels):
        out, compiled = inner(plan, pilot_table, runtimes, solve, scal, u,
                              solve_channels)
        seen.append(dict(runtimes=runtimes, solve=solve, scal=scal, u=u,
                         channels=solve_channels, out=out))
        return out, compiled

    ex.execute_fused = spy
    return seen


SHAPES = {"q6": q6, "sum_count": sum_count, "sum_or": sum_or, "ratio": ratio}


@pytest.mark.parametrize("shape", list(SHAPES))
@pytest.mark.parametrize("seed", [0, 3])
def test_run_fused_matches_the_reference(catalogs, shape, seed):
    ref_cat, cat = catalogs
    spec_r, spec_t = RefErrorSpec(**SPEC), ErrorSpec(**SPEC)
    ex_r, ex_t = RefExecutor(ref_cat), Executor(cat, device="cpu")
    seen_r, seen_t = _spy_fused(ex_r), _spy_fused(ex_t)
    ans_r = RefPilotDB(ex_r).run_fused(ref_q(SHAPES[shape]), spec_r, seed=seed)
    ans_t = PilotDB(ex_t).run_fused(port_q(SHAPES[shape]), spec_t, seed=seed)
    assert (ans_r is None) == (ans_t is None)
    assert ans_t is not None
    assert len(seen_r) == len(seen_t) == 1
    (r,), (t,) = seen_r, seen_t
    # the same host inputs: pilot ids, quantile table, cost line, uniforms
    np.testing.assert_array_equal(r["runtimes"]["lineitem"].ids,
                                  t["runtimes"]["lineitem"].ids)
    np.testing.assert_allclose(t["solve"], r["solve"], rtol=1e-12)
    np.testing.assert_allclose(t["scal"], r["scal"], rtol=1e-12)
    np.testing.assert_array_equal(t["u"], r["u"])
    assert tuple(t["channels"]) == tuple(r["channels"])
    ro, to = r["out"], t["out"]
    assert (ro["flags"], ro["nsel"]) == (to["flags"], to["nsel"])
    n_real = t["runtimes"]["lineitem"].n_real
    np.testing.assert_allclose(to["theta"], ro["theta"],
                               rtol=theta_rtol(ro, n_real, r["channels"]))
    np.testing.assert_array_equal(to["padded"], ro["padded"][:ro["nsel"]])
    np.testing.assert_allclose(to["block_sums"][:n_real], ro["block_sums"][:n_real],
                               rtol=1e-5, atol=1e-3)
    rr, rt = ans_r.report, ans_t.report
    assert rr.fallback == rt.fallback
    assert (rr.plan is None) == (rt.plan is None)
    if rr.plan is not None:
        for table, rate in rr.plan.rates.items():
            assert rt.plan.rates[table] == pytest.approx(rate, rel=1e-6)
    assert rr.n_pilot_blocks == rt.n_pilot_blocks
    assert rr.final_scanned_bytes == rt.final_scanned_bytes
    np.testing.assert_allclose(ans_t.values, ans_r.values, rtol=1e-5)


@pytest.mark.parametrize("shape", list(SHAPES))
def test_solve_plain_version_matches_the_reference_program(catalogs, shape):
    """taqa_solve's plain versions on the reference's own pilot sums and
    host inputs: theta within :func:`theta_rtol`, flags, nsel and padded
    exactly."""
    ref_cat, _ = catalogs
    ex_r = RefExecutor(ref_cat)
    seen = _spy_fused(ex_r)
    RefPilotDB(ex_r).run_fused(ref_q(SHAPES[shape]), RefErrorSpec(**SPEC), seed=1)
    (r,) = seen
    out = r["out"]
    n_real = r["runtimes"]["lineitem"].n_real
    bs = torch.from_numpy(out["block_sums"][:, 0, :].astype(np.float32))
    assert torch.all(bs[n_real:] == 0)
    theta, flags = taqa_solve_rate(
        bs, torch.from_numpy(out["present"][:1].copy()), n_real,
        torch.tensor(r["channels"], dtype=torch.int32),
        torch.from_numpy(np.asarray(r["solve"], np.float32)),
        torch.from_numpy(np.asarray(r["scal"], np.float32)))
    assert int(flags[0]) == out["flags"]
    assert float(theta[0]) == pytest.approx(
        out["theta"], rel=theta_rtol(out, n_real, r["channels"]))
    nsel, padded = taqa_draw_compact(torch.from_numpy(np.asarray(r["u"], np.float32)),
                                     theta[1:])
    assert int(nsel[0]) == out["nsel"]
    np.testing.assert_array_equal(padded.numpy(), out["padded"])


def test_solve_sums_in_the_kernel_order():
    """The plain version's s1 adds thread-strided rows, then a xor butterfly
    per warp, then the warps in order: within f32 rounding of an f64 sum,
    and the plain and a row-order loop differ only in rounding."""
    rng = np.random.default_rng(4)
    for rows in (0, 1, 255, 256, 257, 2048, 5000):
        y = rng.normal(100.0, 30.0, (rows, 3)).astype(np.float32)
        got = solve_ref._ordered_sum(torch.from_numpy(y)).numpy()
        np.testing.assert_allclose(got, y.astype(np.float64).sum(axis=0),
                                   rtol=1e-5, atol=1e-3)


def test_draw_compact_plain_version():
    rng = np.random.default_rng(9)
    for n in (1, 4095, 4096, 4097, 50_000):
        u = rng.random(n).astype(np.float32)
        for theta in (0.0, 0.01, 0.5, 1.0):
            nsel, padded = taqa_draw_compact_ref(torch.from_numpy(u),
                                                 torch.tensor([theta], dtype=torch.float32))
            ids = np.nonzero(u < np.float32(theta))[0]
            assert int(nsel[0]) == len(ids)
            np.testing.assert_array_equal(padded[:len(ids)].numpy(), ids)
            assert not padded[len(ids):].any()


@pytest.mark.parametrize("num_blocks", [1, 63, 64, 65, 1000, 4096, 18_750])
def test_fused_buckets_are_the_solo_padding(num_blocks):
    buckets = physical.fused_buckets(num_blocks)
    for n in range(num_blocks + 1):
        b = buckets[sum(n > x for x in buckets[:-1])]
        _, _, n_phys = pad_block_ids(np.zeros(n, np.int32), num_blocks)
        assert b == n_phys, (n, b, n_phys)


def test_straddling_uniform_takes_the_verified_solo_rerun(catalog, monkeypatch):
    """A device theta one f32 ulp above a uniform the f64 plan rejects: the
    device draw keeps one block more than the host's, the verification sees
    it and runs stage 2 solo — still bitwise the two-stage answer."""
    spec = ErrorSpec(**SPEC)
    ans_a = PilotDB(Executor(catalog, device="cpu")).query(port_q(q6), spec, seed=2)
    real = physical.taqa_draw_compact
    nudged = []

    def straddle(u, theta_eff):
        above = u[u >= theta_eff]
        theta = torch.nextafter(above.min(), torch.tensor(float("inf"))).reshape(1)
        nudged.append((float(theta_eff[0]), float(theta[0])))
        return real(u, theta)

    monkeypatch.setattr(physical, "taqa_draw_compact", straddle)
    ex = Executor(catalog, device="cpu")
    ans_b = PilotDB(ex).run_fused(port_q(q6), spec, seed=2)
    assert len(nudged) == 1 and nudged[0][1] > nudged[0][0]
    np.testing.assert_array_equal(ans_a.values, ans_b.values)
    assert dict(ans_a.report.plan.rates) == dict(ans_b.report.plan.rates)
    assert ex.device_dispatches == 2  # the fused program, then the solo final
    assert ex.queries_run == 1


def test_kernel_errors_propagate(catalog, monkeypatch):
    """A kernel that fails to build or launch is raised, never swallowed
    into a quiet two-stage re-run: run_fused raises, and a fused session's
    handle fails with the error through sql and through the drain."""
    def broken(*args, **kwargs):
        raise RuntimeError("taqa_solve kernel launch failed: CUDA error 209 "
                           "(no kernel image is available)")

    monkeypatch.setattr(physical, "taqa_solve_rate", broken)
    spec = ErrorSpec(**SPEC)
    with pytest.raises(RuntimeError, match="taqa_solve kernel launch failed"):
        PilotDB(Executor(catalog, device="cpu")).run_fused(port_q(q6), spec, seed=0)
    s = Session(catalog, seed=11, device="cpu", config=FUSED)
    h = s.sql(SQL)
    assert h.status == "failed" and "taqa_solve kernel launch failed" in h.error
    h2 = s.submit(SQL.replace("ERROR 8%", "ERROR 9%"))
    s.drain()
    assert h2.status == "failed" and "taqa_solve kernel launch failed" in h2.error
    # the two-stage session never reaches the kernel
    s2 = Session(catalog, seed=11, device="cpu", config=BASE)
    assert s2.sql(SQL).status == "done"
    s.close()
    s2.close()


def test_taqa_wrappers_refuse_other_devices_and_bad_shapes():
    """Only a CPU tensor reaches a plain version; a tensor on another
    non-CUDA device, or of the wrong shape or type, is refused."""
    meta = lambda *shape, dtype=torch.float32: torch.zeros(*shape, dtype=dtype,
                                                           device="meta")
    with pytest.raises(ValueError, match="cuda or cpu"):
        taqa_draw_compact(meta(10), meta(1))
    with pytest.raises(ValueError, match="cuda or cpu"):
        taqa_solve_rate(meta(64, 2), meta(1, dtype=torch.bool), 5,
                        meta(1, dtype=torch.int32), meta(1, 5), meta(6))
    cpu = lambda *shape, dtype=torch.float32: torch.zeros(*shape, dtype=dtype)
    with pytest.raises(ValueError, match="theta_eff"):
        taqa_draw_compact(cpu(10), cpu(2))
    with pytest.raises(ValueError, match="u must be"):
        taqa_draw_compact(cpu(10, dtype=torch.float64), cpu(1))
    with pytest.raises(ValueError, match="solve must be"):
        taqa_solve_rate(cpu(64, 2), cpu(1, dtype=torch.bool), 5,
                        cpu(2, dtype=torch.int32), cpu(1, 5), cpu(6))
    with pytest.raises(ValueError, match="n_real"):
        taqa_solve_rate(cpu(64, 2), cpu(1, dtype=torch.bool), 65,
                        cpu(1, dtype=torch.int32), cpu(1, 5), cpu(6))
