"""Grouped + join analytics with guarantees on the PyTorch/CUDA port,
through the Session front door: the port's counterpart of
``examples/aqp_analytics.py``.

    python examples/torch_aqp_analytics.py                         # the card
    python examples/torch_aqp_analytics.py --device cpu --rows 200000 --error 15

Shows the three client surfaces over one session:
  * SQL with ``ERROR e% CONFIDENCE p%``: a grouped query, a join and a
    ratio whose triple product no column kernel takes — all three on the
    gather route, reduced by the ``segment_sum`` kernel;
  * the fluent builder (``session.table(...).where(...).agg(...)``);
  * the scheduler: a herd of constant-varied grouped queries drains as one
    group, one pilot per member and its finals batched.

On the card the gather route runs the hand-written ``segment_sum`` kernel,
on the CPU its plain PyTorch version.
"""

import argparse
import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)), "..", "src"))

import numpy as np

from repro_torch.api import Session, SessionConfig, avg_, count_, sum_
from repro_torch.engine.datagen import tpch_catalog
from repro_torch.engine.expr import Col
from repro_torch.kernels.segment_sum import segment_sum


def show(name, approx, exact, error_target):
    a, e = approx.result(), exact.result()
    errs = []
    for i in range(len(a.names)):
        for g in range(a.values.shape[1]):
            t = e.values[i, g]
            if e.group_present[g] and np.isfinite(t) and abs(t) > 1e-9:
                errs.append(abs(a.values[i, g] - t) / abs(t))
    r = approx.report
    frac = (r.pilot_scanned_bytes + r.final_scanned_bytes) / r.exact_scanned_bytes
    print(f"[{name}] max err {max(errs):.3%} (target {error_target:.0%}), "
          f"scanned {frac:.1%}, plan={r.plan.rates if r.plan else r.fallback}")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    ap.add_argument("--rows", type=int, default=2_000_000, help="lineitem rows")
    ap.add_argument("--error", type=int, default=5, help="ERROR e%% of every query")
    ap.add_argument("--seed", type=int, default=7, help="session seed")
    args = ap.parse_args(argv)
    target = args.error / 100
    guarantee = f" ERROR {args.error}% CONFIDENCE 95%"
    catalog = tpch_catalog(scale_rows=args.rows, block_rows=32, seed=0,
                           device=args.device)
    session = Session(catalog, seed=args.seed, device=args.device,
                      config=SessionConfig(result_cache_size=0))

    # -- SQL front door ------------------------------------------------------
    grouped = ("SELECT SUM(l_quantity) AS qty, AVG(l_extendedprice) AS avg_price, "
               "COUNT(*) AS orders FROM lineitem GROUP BY l_returnflag")
    join = ("SELECT SUM(l_extendedprice) AS rev FROM lineitem "
            "JOIN orders ON l_orderkey = o_orderkey WHERE o_orderdate < 1200")
    ratio = ("SELECT SUM(l_extendedprice * l_discount * l_linestatus) / "
             "SUM(l_extendedprice * l_discount) AS promo_share FROM lineitem "
             "WHERE l_shipdate BETWEEN 400 AND 2200")
    for name, sql in (("grouped Q1", grouped), ("join     ", join), ("ratio Q14", ratio)):
        show(name, session.sql(sql + guarantee), session.sql(sql), target)

    # -- fluent builder (lowers to the identical internal plan) --------------
    def builder():
        return (session.table("lineitem")
                .where(Col("l_shipdate") < 2400)
                .group_by("l_returnflag")
                .agg(sum_(Col("l_quantity")).as_("qty"),
                     avg_(Col("l_extendedprice")).as_("avg_price"),
                     count_().as_("orders")))

    show("builder  ", builder().error(target, 0.95).run(), builder().run(), target)

    # -- the scheduler: a grouped herd drains as one group -------------------
    herd = [f"SELECT SUM(l_quantity) AS qty, COUNT(*) AS n FROM lineitem "
            f"WHERE l_shipdate < {x} GROUP BY l_returnflag" + guarantee
            for x in (1800, 2000, 2200, 2400)]
    handles = [session.submit(q) for q in herd]
    session.drain()
    stats = session.scheduler.last_drain
    print(f"[runtime] {stats.n_queries} grouped queries in {stats.n_groups} "
          f"group(s): {stats.pilots_run} pilot stage(s), "
          f"{stats.compile_misses} new compilations, "
          f"{stats.wall_time_s * 1e3:.0f} ms total")
    assert all(h.status == "done" for h in handles)
    print(f"[kernels] segment_sum: {segment_sum.launches} CUDA launches, "
          f"{segment_sum.calls} calls")
    session.close()
    return 0


if __name__ == "__main__":
    sys.exit(main())
