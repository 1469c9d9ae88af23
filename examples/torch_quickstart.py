"""Quickstart on the PyTorch/CUDA port: stream an approximate SQL answer
with an a-priori error guarantee — the port's counterpart of
``examples/quickstart.py``.

    python examples/torch_quickstart.py                          # the card
    python examples/torch_quickstart.py --device cpu --rows 200000

Builds a TPC-H-like catalog, opens a :class:`repro_torch.api.Session` and
sends the quickstart Q6 with ``ERROR 5% CONFIDENCE 95%`` through
``session.sql(..., stream=True)``.  The handle's stream first yields the
advisory pilot frame — a provisional estimate with a t-interval, computed
from the pilot sample alone, no guarantee — then the final frame, whose
answer carries the guarantee.  The exact answer is printed beside both.
On the card the pilot and the final run the hand-written ``filtered_agg``
kernel, on the CPU its plain PyTorch version.
"""

import argparse
import os
import sys
import time

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)), "..", "src"))

from repro_torch.api import Session, SessionConfig
from repro_torch.engine.datagen import tpch_catalog

SQL = ("SELECT SUM(l_extendedprice * l_discount) AS revenue FROM lineitem "
       "WHERE l_shipdate BETWEEN 100 AND 1500 AND l_discount BETWEEN 0.02 AND 0.08")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    ap.add_argument("--rows", type=int, default=2_000_000, help="lineitem rows")
    ap.add_argument("--error", type=int, default=5, help="ERROR e%%")
    ap.add_argument("--seed", type=int, default=42, help="session seed")
    args = ap.parse_args(argv)
    print(f"building a {args.rows:,}-row catalog on {args.device} ...")
    catalog = tpch_catalog(scale_rows=args.rows, block_rows=32, seed=0,
                           device=args.device)
    session = Session(catalog, seed=args.seed, device=args.device,
                      config=SessionConfig(result_cache_size=0))
    exact = session.sql(SQL).scalar("revenue")

    t0 = time.perf_counter()
    handle = session.sql(f"{SQL} ERROR {args.error}% CONFIDENCE 95%",
                         stream=True)
    for frame in handle.stream():
        t = frame.emitted_at * 1e3
        if frame.kind == "pilot":
            est, hw = frame.scalar("revenue"), frame.half_width("revenue")
            print(f"pilot  : {est:.6g} +- {hw:.3g} (advisory, "
                  f"{frame.confidence:.0%} t-interval over "
                  f"{frame.n_pilot_blocks} pilot blocks; {t:.1f} ms)")
        else:
            r = frame.report
            err = abs(frame.scalar("revenue") - exact) / abs(exact)
            scanned = r.pilot_scanned_bytes + r.final_scanned_bytes
            print(f"{frame.kind:6} : {frame.scalar('revenue'):.6g}  "
                  f"(guaranteed <= {args.error}% w.p. 95%; achieved "
                  f"{err:.3%}; {t:.1f} ms)")
            print(f"plan   : {r.plan.rates if r.plan else r.fallback}; "
                  f"scanned {scanned / r.exact_scanned_bytes:.2%} of the bytes")
    print(f"exact  : {exact:.6g}   (wall of the streamed query "
          f"{(time.perf_counter() - t0) * 1e3:.1f} ms)")
    session.close()
    if handle.status != "done":
        print(f"failed: {handle.error}", file=sys.stderr)
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
