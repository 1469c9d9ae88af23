"""scan_pct: the median, over the window's approximate queries, of the
bytes the pilot and the final scanned as a share of what the exact query
scans (``TaqaReport``'s scanned-byte counters): what BSAP's plan saves."""

import numpy as np

from pilotbench.metrics import approximate


def read(ctx):
    v = [100.0 * (r.report["pilot_scanned_bytes"] + r.report["final_scanned_bytes"])
         / r.report["exact_scanned_bytes"]
         for r in approximate(ctx) if r.report["exact_scanned_bytes"]]
    return float(np.median(v)) if v else None
