#!/usr/bin/env python3
"""Run the PyTorch/CUDA port of PilotDB (``src/repro_torch``) on one NVIDIA
card and check it.

    python3 chip_smoke.py

Phases, each printing its own lines:

1. device  — ``nvidia-smi`` name and power limit, ``torch.cuda`` device name.
2. build   — ``nvcc`` builds every kernel from the checkout's sources, all
             started together; build seconds and ptxas register counts.
3. kernels — each hand-written kernel against its plain PyTorch version on
             the card (block_rows 32 / 100 / 256; empty blocks, padding ids,
             an int32 filter column, rows on a bound): counts exact, sums
             within rtol 1e-5, two launches bitwise equal.  Then each kernel
             is timed with CUDA events at the main path's shapes (SF10
             lineitem columns, n_phys = 937 and 65,536, L2 flushed before
             every launch) beside its plain version and its bytes bound.
4. main    — the port's main path at TPC-H SF10 lineitem cardinality
             (60M rows, block_rows 32, 1.875M blocks, ~2.6 GB on the card):
             Session.sql for the quickstart Q6 query and a filterless
             SUM/COUNT query, each with and without ERROR 5% CONFIDENCE 95%.
             The launch counters are zeroed just before and read just after;
             both kernels must have launched, every query must finish, and
             each approximate answer must lie within 5% of the exact one
             (or carry a fallback).  The exact Q6 answer is checked against
             an f64 numpy sum of the same data.  Prints the pilot, rate-solve,
             final and exact wall times (median of 5 warm runs), the scanned
             fraction, and the exact/approx wall ratio.
5. devices — at 200k rows a CUDA session and a ``device="cpu"`` session of
             the port, equal seeds: equal pilot draws, final block ids and
             fallback; rates within rtol 1e-6; answers within rtol 1e-5.

Then one JSON line of per-kernel numbers, the ``nvidia-smi`` line again, and
last ``{"ok": true, "device": {...}}``.  Any failed check raises, so the
script exits non-zero; so it does, printing no result, when there is no CUDA
device or no ``src/repro_torch`` beside it.
"""

import json
import os
import statistics
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
SRC = os.path.join(ROOT, "src")

HBM_BYTES_PER_S = 3.35e12        # H100 SXM device memory (data sheet)
SF10_ROWS = 60_000_000           # TPC-H SF10 lineitem cardinality
BLOCK_ROWS = 32
TIMED_N_PHYS = (937, 65_536)     # the SF10 pilot's real blocks; a large final
WARM_RUNS = 5

Q6 = ("SELECT SUM(l_extendedprice * l_discount) AS revenue FROM lineitem "
      "WHERE l_shipdate BETWEEN 100 AND 1500 AND l_discount BETWEEN 0.02 AND 0.08")
SUM_COUNT = "SELECT SUM(l_extendedprice) AS s, COUNT(*) AS n FROM lineitem"
GUARANTEE = " ERROR 5% CONFIDENCE 95%"


def check(cond, msg):
    if not cond:
        raise AssertionError(msg)


def nvidia_smi_line():
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


# ---------------------------------------------------------------------------
# phase 3 helpers
# ---------------------------------------------------------------------------

def random_columns(torch, np, block_rows, n_blocks, seed):
    """Q6-shaped columns with an empty block, rows on the discount bounds, an
    int32 filter column, and ids with repeats and zero padding."""
    rng = np.random.default_rng(seed)
    n = n_blocks * block_rows
    cols = {
        "price": rng.uniform(900.0, 1100.0, n).astype(np.float32),
        "discount": rng.integers(0, 11, n).astype(np.float32) / 100.0,
        "shipdate": rng.integers(0, 2526, n).astype(np.int32),
        "quantity": rng.integers(1, 51, n).astype(np.float32),
    }
    valid = rng.random(n) < 0.9
    valid[5 * block_rows:6 * block_rows] = False
    real = np.concatenate([rng.integers(0, n_blocks, 900), [5, 5, 0]])
    ids = np.concatenate([real, np.zeros(124)]).astype(np.int32)
    dev = torch.device("cuda")
    out = {k: torch.from_numpy(v).to(dev) for k, v in cols.items()}
    out["valid"] = torch.from_numpy(valid).to(dev)
    out["ids"] = torch.from_numpy(ids).to(dev)
    return out


def bitwise_equal(torch, a, b):
    """Equal bit patterns (torch.equal treats the NaN sentinel as unequal)."""
    return torch.equal(a.view(torch.int32), b.view(torch.int32))


def compare(torch, name, got, want, count_cols):
    """Counts exact, sums within rtol 1e-5, min/max exact (NaN sentinel
    included).  Returns the max absolute difference."""
    check(got.shape == want.shape, f"{name}: shape {tuple(got.shape)} vs {tuple(want.shape)}")
    check(torch.equal(got[:, :count_cols], want[:, :count_cols]),
          f"{name}: counts differ from the plain version")
    torch.testing.assert_close(got[:, count_cols:3], want[:, count_cols:3],
                               rtol=1e-5, atol=0, msg=f"{name}: sums differ")
    if got.shape[1] > 3:
        torch.testing.assert_close(got[:, 3:], want[:, 3:], rtol=0, atol=0,
                                   equal_nan=True, msg=f"{name}: min/max differ")
    diff = (got - want).abs()
    return float(torch.nan_to_num(diff, nan=0.0).max())


def time_cold(torch, fn, iters=30):
    """Median device ms of ``fn`` with the 50 MB L2 flushed before every
    launch (a sampled scan finds its blocks cold), each launch timed by CUDA
    events.  A device-side sleep queued ahead of the start event keeps the
    card busy while the host enqueues ``fn``, so the events bracket device
    work only, not the wrapper's host overhead."""
    flush = torch.empty(256 << 20, dtype=torch.uint8, device="cuda")
    fn()
    times = []
    for _ in range(iters):
        flush.zero_()
        torch.cuda._sleep(1_000_000)   # ~0.5 ms at H100 clocks
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    del flush
    return statistics.median(times)


def device_busy_ms(torch, fn):
    """(device kernel ms, host wall ms) of one call of ``fn`` under
    torch.profiler; the kernel ms is None when the profiler saw no device
    time."""
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3
    from torch.autograd import DeviceType
    # summed like the profiler table's "Self CUDA time total": device-side
    # events only (kernels, copies), never the CPU ops that launched them
    busy = sum(ev.self_device_time_total for ev in prof.key_averages()
               if ev.device_type == DeviceType.CUDA
               and not getattr(ev, "is_user_annotation", False))
    return (busy / 1e3 if busy > 0 else None), wall


# ---------------------------------------------------------------------------
# phase 4/5 helpers
# ---------------------------------------------------------------------------

def spy(session):
    """Record the pilot draws and final block ids a session's executor runs."""
    seen = {"pilots": [], "final_ids": []}
    ex = session.executor
    execute, execute_pilot = ex.execute, ex.execute_pilot

    def spy_pilot(plan, table, theta_p, seed, pair_tables=()):
        seen["pilots"].append((table, theta_p, seed))
        return execute_pilot(plan, table, theta_p, seed, pair_tables=pair_tables)

    def spy_execute(plan):
        res = execute(plan)
        seen["final_ids"].append({t: i.sampled_block_ids
                                  for t, i in res.sample_infos.items()})
        return res

    ex.execute_pilot, ex.execute = spy_pilot, spy_execute
    return seen


def run_sql(torch, session, sql):
    t0 = time.perf_counter()
    h = session.sql(sql)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    check(h.status == "done", f"query failed: {h.error}\n{sql}")
    return h, wall


def main() -> int:
    if not os.path.isdir(os.path.join(SRC, "repro_torch")):
        print("chip_smoke: src/repro_torch not found beside this script",
              file=sys.stderr)
        return 2
    import numpy as np
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device (torch.cuda.is_available() is False)",
              file=sys.stderr)
        return 2
    sys.path.insert(0, SRC)
    from repro_torch.api import Session
    from repro_torch.engine.datagen import tpch_catalog
    from repro_torch.kernels import _build
    from repro_torch.kernels.block_agg import block_agg, block_agg_ref
    from repro_torch.kernels.filtered_agg import filtered_agg, filtered_agg_ref

    t_start = time.perf_counter()
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda")

    # -- 1. device -----------------------------------------------------------
    smi = nvidia_smi_line()
    name = torch.cuda.get_device_name(0)
    print(f"[device] nvidia-smi: {smi}")
    print(f"[device] torch: {name}, {torch.cuda.device_count()} device(s), "
          f"torch {torch.__version__}, CUDA {torch.version.cuda}")

    # -- 2. build ------------------------------------------------------------
    t0 = time.perf_counter()
    paths = _build.build()
    print(f"[build] {len(paths)} kernels in {time.perf_counter() - t0:.2f} s "
          f"(nvcc {' '.join(_build.NVCC_FLAGS)})")
    for k, log in _build.build_logs.items():
        regs = [ln.strip() for ln in log.splitlines() if "registers" in ln]
        print(f"[build] {k}: {_build.build_seconds[k]:.2f} s; " + " | ".join(regs))

    # -- 3. kernels against their plain versions -------------------------------
    bounds = torch.tensor([100.0, 1500.0, 0.02, 0.08, 24.0],
                          dtype=torch.float32, device=dev)
    for br in (32, 100, 256):
        c = random_columns(torch, np, br, 4096, seed=br)
        fa_args = (c["price"], c["discount"], c["shipdate"], c["discount"],
                   c["quantity"], c["valid"], br, c["ids"], bounds)
        a, b = filtered_agg(*fa_args), filtered_agg(*fa_args)
        check(bitwise_equal(torch, a, b), f"filtered_agg br={br}: launches differ bitwise")
        compare(torch, f"filtered_agg br={br}", a, filtered_agg_ref(*fa_args), 1)
        on_bound = (c["discount"] == torch.tensor(0.02, device=dev)).any()
        check(bool(on_bound), "no row on the 0.02 bound")
        for vname in ("price", "shipdate", "valid"):
            ba_args = (c[vname], c["valid"], br, c["ids"])
            a, b = block_agg(*ba_args), block_agg(*ba_args)
            check(bitwise_equal(torch, a, b), f"block_agg br={br} {vname}: launches differ")
            compare(torch, f"block_agg br={br} {vname}", a, block_agg_ref(*ba_args), 1)
            check(bool(torch.isnan(a[900, 3])), "empty block lacks the NaN sentinel")
        print(f"[kernels] block_rows={br}: filtered_agg and block_agg (f32, "
              "int32, bool values) match their plain versions; bitwise stable")
    torch.cuda.synchronize()

    # -- 4. main path at SF10 --------------------------------------------------
    t0 = time.perf_counter()
    catalog = tpch_catalog(scale_rows=SF10_ROWS, block_rows=BLOCK_ROWS, seed=0)
    torch.cuda.synchronize()
    li = catalog["lineitem"]
    print(f"[main] tpch_catalog(scale_rows={SF10_ROWS:,}, block_rows={BLOCK_ROWS}): "
          f"{li.num_blocks:,} lineitem blocks, "
          f"{sum(t.total_bytes() for t in catalog.values()) / 1e9:.3f} GB of columns "
          f"on the card, built in {time.perf_counter() - t0:.1f} s")

    # kernel timing at the main path's shapes, on the SF10 columns
    cols = li.columns
    q6_bounds = torch.tensor([100.0, 1500.0, 0.02, 0.08, 3.0e38],
                             dtype=torch.float32, device=dev)
    timed = {"filtered_agg": {}, "block_agg": {}}
    rng = np.random.default_rng(7)
    for n_phys in TIMED_N_PHYS:
        ids_np = np.sort(rng.choice(li.num_blocks, n_phys, replace=False)).astype(np.int32)
        ids = torch.from_numpy(ids_np).to(dev)
        fa = (cols["l_extendedprice"], cols["l_discount"], cols["l_shipdate"],
              cols["l_discount"], cols["l_shipdate"], li.valid, BLOCK_ROWS, ids,
              q6_bounds)
        ba = (cols["l_extendedprice"], li.valid, BLOCK_ROWS, ids)
        # bytes each function must move: the distinct columns it reads (Q6
        # passes l_discount and l_shipdate twice), once per sampled row, plus
        # ids, bounds and output
        rows = n_phys * BLOCK_ROWS
        fa_bytes = rows * (4 + 4 + 4 + 1) + n_phys * 4 + 20 + n_phys * 3 * 4
        ba_bytes = rows * (4 + 1) + n_phys * 4 + n_phys * 5 * 4
        for kname, fn, ref, args, nbytes in (
                ("filtered_agg", filtered_agg, filtered_agg_ref, fa, fa_bytes),
                ("block_agg", block_agg, block_agg_ref, ba, ba_bytes)):
            err = compare(torch, f"{kname} SF10 n_phys={n_phys}", fn(*args),
                          ref(*args), 1)
            ms = time_cold(torch, lambda: fn(*args))
            plain_ms = time_cold(torch, lambda: ref(*args))
            bound_ms = nbytes / HBM_BYTES_PER_S * 1e3
            timed[kname][n_phys] = dict(ms=ms, plain_ms=plain_ms,
                                        bound_ms=bound_ms, bytes=nbytes,
                                        max_abs_err=err)
            print(f"[kernels] {kname} n_phys={n_phys:,}: {ms * 1e3:.2f} us "
                  f"(plain {plain_ms * 1e3:.2f} us, bound {bound_ms * 1e3:.3f} us "
                  f"= {nbytes:,} B / 3.35 TB/s, {bound_ms / ms:.1%} of bound); "
                  f"max |kernel - plain| {err:.3g}  [{smi}]")
    torch.cuda.synchronize()

    session = Session(catalog, seed=42)
    queries = {"q6": Q6, "sum_count": SUM_COUNT}
    filtered_agg.launches = 0
    block_agg.launches = 0
    first = {}
    for qn, sql in queries.items():
        first[qn] = (run_sql(torch, session, sql),
                     run_sql(torch, session, sql + GUARANTEE))
    launches = {"filtered_agg": filtered_agg.launches,
                "block_agg": block_agg.launches}
    print(f"[main] kernel launches on the main path: {launches}")
    check(launches["filtered_agg"] > 0, "the Q6 path never launched filtered_agg")
    check(launches["block_agg"] > 0, "the SUM/COUNT path never launched block_agg")

    # correctness of the exact route at full size: f64 numpy over the same data
    price = cols["l_extendedprice"].cpu().numpy().astype(np.float64)
    disc32 = cols["l_discount"].cpu().numpy()
    ship32 = cols["l_shipdate"].cpu().numpy().astype(np.float32)
    keep = ((ship32 >= np.float32(100)) & (ship32 <= np.float32(1500))
            & (disc32 >= np.float32(0.02)) & (disc32 <= np.float32(0.08)))
    truth = {"q6": [float((price * disc32.astype(np.float64))[keep].sum())],
             "sum_count": [float(price.sum()), float(SF10_ROWS)]}
    del price, disc32, ship32, keep

    for qn, ((eh, _), (ah, _)) in first.items():
        exact = eh.answer.values[:, 0]
        approx = ah.answer.values[:, 0]
        check(np.all(np.isfinite(exact)) and np.all(np.isfinite(approx)),
              f"{qn}: non-finite answer")
        np.testing.assert_allclose(exact, truth[qn], rtol=1e-5,
                                   err_msg=f"{qn}: exact answer vs f64 numpy")
        rel = np.abs(approx - exact) / np.abs(exact)
        r = ah.report
        check(bool(np.all(rel <= 0.05)) or r.fallback is not None,
              f"{qn}: error {rel} above 5% without a fallback")
        print(f"[main] {qn}: exact {exact.tolist()} (f64 numpy {truth[qn]}); "
              f"approx {approx.tolist()}, error {rel.max():.4%}, "
              f"fallback {r.fallback}, plan {r.plan.rates if r.plan else None}, "
              f"pilot blocks {r.n_pilot_blocks}")

    summary = {}
    for qn, sql in queries.items():
        walls, exact_walls = [], []
        stage = {"pilot": [], "rate_solve": [], "final": []}
        for _ in range(WARM_RUNS):
            eh, ew = run_sql(torch, session, sql)
            ah, aw = run_sql(torch, session, sql + GUARANTEE)
            exact_walls.append(ew)
            walls.append(aw)
            stage["pilot"].append(ah.report.pilot_time_s)
            stage["rate_solve"].append(ah.report.plan_time_s)
            stage["final"].append(ah.report.final_time_s)
        r = ah.report
        scanned = (r.pilot_scanned_bytes + r.final_scanned_bytes) / r.exact_scanned_bytes
        med = {k: statistics.median(v) * 1e3 for k, v in stage.items()}
        approx_ms = statistics.median(walls) * 1e3
        exact_ms = statistics.median(exact_walls) * 1e3
        summary[qn] = dict(approx_ms=approx_ms, exact_ms=exact_ms,
                           scanned_fraction=scanned, **{f"{k}_ms": v for k, v in med.items()})
        print(f"[main] {qn} (median of {WARM_RUNS} warm runs): approx {approx_ms:.2f} ms "
              f"= pilot {med['pilot']:.2f} + rate solve {med['rate_solve']:.2f} + final "
              f"{med['final']:.2f} ms (+ parse/plan); exact {exact_ms:.2f} ms; "
              f"scanned {scanned:.4%} of the exact bytes; exact/approx wall "
              f"{exact_ms / approx_ms:.3f}x  [{smi}]")
    # where an approximate query's time goes: device busy share under the
    # profiler, and the host Bernoulli draw over every block (done twice per
    # query, pilot and final)
    from repro_torch.engine.sampling import draw_block_ids
    draws = []
    for i in range(WARM_RUNS):
        t0 = time.perf_counter()
        draw_block_ids(li.num_blocks, 0.0005, i)
        draws.append((time.perf_counter() - t0) * 1e3)
    draw_ms = statistics.median(draws)
    print(f"[main] host draw_block_ids over {li.num_blocks:,} blocks: "
          f"{draw_ms:.2f} ms (median of {WARM_RUNS})")
    for qn, sql in queries.items():
        for kind, text in (("approx", sql + GUARANTEE), ("exact", sql)):
            busy, wall = device_busy_ms(torch, lambda: session.sql(text))
            summary[qn][f"{kind}_device_busy_ms"] = busy
            summary[qn][f"{kind}_profiled_wall_ms"] = wall
            share = "not measured" if busy is None else f"{1 - busy / wall:.1%}"
            print(f"[main] {qn} {kind} under torch.profiler: device kernels "
                  f"{busy if busy is None else round(busy, 4)} ms of {wall:.2f} ms "
                  f"wall; device idle share {share}  [{smi}]")
    summary["draw_block_ids_ms"] = draw_ms
    del session, catalog, cols, li
    torch.cuda.empty_cache()

    # -- 5. the same route on both devices -------------------------------------
    answers = {}
    for devname in ("cuda", "cpu"):
        cat = tpch_catalog(scale_rows=200_000, block_rows=BLOCK_ROWS, seed=0,
                           device=devname)
        s = Session(cat, seed=42, device=devname)
        seen = spy(s)
        hs = [s.sql(sql + GUARANTEE) for sql in (Q6, SUM_COUNT)]
        for h in hs:
            check(h.status == "done", f"{devname}: {h.error}")
        answers[devname] = (hs, seen)
    (gh, gseen), (ch, cseen) = answers["cuda"], answers["cpu"]
    check(gseen["pilots"] == cseen["pilots"], "pilot draws differ between devices")
    check(len(gseen["final_ids"]) == len(cseen["final_ids"]), "final count differs")
    for a, b in zip(gseen["final_ids"], cseen["final_ids"]):
        check(a.keys() == b.keys() and all(np.array_equal(a[t], b[t]) for t in a),
              "final block ids differ between devices")
    for g, c in zip(gh, ch):
        check(g.fallback == c.fallback, "fallback differs between devices")
        check((g.report.plan is None) == (c.report.plan is None), "plans differ")
        if g.report.plan is not None:
            for t, rate in g.report.plan.rates.items():
                rc = c.report.plan.rates[t]
                check(abs(rate - rc) <= 1e-6 * abs(rc), f"rates differ: {rate} vs {rc}")
        np.testing.assert_allclose(g.answer.values, c.answer.values, rtol=1e-5)
    print(f"[devices] 200k rows: CUDA and CPU sessions agree (pilot draws and final "
          f"ids equal; rates within 1e-6; answers within 1e-5): "
          f"{[h.answer.values.ravel().tolist() for h in gh]}")

    # -- results ---------------------------------------------------------------
    sources = {"filtered_agg": "src/repro_torch/kernels/filtered_agg/csrc/filtered_agg.cu",
               "block_agg": "src/repro_torch/kernels/block_agg/csrc/block_agg.cu"}
    replaces = {"filtered_agg": "src/repro/kernels/filtered_agg/kernel.py:114",
                "block_agg": "src/repro/kernels/block_agg/kernel.py:92"}
    big = TIMED_N_PHYS[-1]
    kernels = []
    for k in ("filtered_agg", "block_agg"):
        t = timed[k][big]
        kernels.append({
            "name": k, "route": "cuda", "source": sources[k],
            "replaces": replaces[k], "launches": launches[k],
            "max_abs_err": t["max_abs_err"], "ms": t["ms"],
            "plain_ms": t["plain_ms"], "bound_ms": t["bound_ms"],
            "bound_by": "bytes", "library_ms": None, "n_phys": big,
            "by_n_phys": {str(n): {kk: v for kk, v in timed[k][n].items()}
                          for n in TIMED_N_PHYS},
        })
    print(f"[done] {time.perf_counter() - t_start:.1f} s; main path {json.dumps(summary)}")
    print(json.dumps({"kernels": kernels}))
    print(smi)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": name,
                                              "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
