#!/usr/bin/env python3
"""Print a SHA-256 digest of the column kernels' outputs on seeded inputs,
so that two checkouts can be held to each other bit for bit on one card.

    python3 tools/column_kernel_digest.py [--src DIR]

``DIR`` is the ``src`` directory whose ``repro_torch`` to load (default:
this checkout's).  Only the public wrappers are called (``filtered_agg``,
``block_agg`` and their batched twins, unchanged in signature since the
batched ones were added), at block_rows 32, 100 and 256 on a 4,096-block
table: solo calls on 1, 7, 101, 1,024 and 65,536 ids (an empty block,
repeated ids, zero padding) and batched calls of 3 x 101 and 8 x 512 ids
with per-lane bounds; Q6's aliased columns, y absent, a bool x, an int32
third filter; block_agg on f32, int32 and COUNT-only.  Prints one line per
wrapper, ``<name> <launches> <sha256>``, then ``all <sha256>``.  Equal
lines from two checkouts mean bitwise equal outputs.  Needs a CUDA card.
"""

import argparse
import hashlib
import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--src", default=os.path.join(ROOT, "src"))
    src = os.path.abspath(ap.parse_args().src)
    import numpy as np
    import torch
    if not torch.cuda.is_available():
        print("column_kernel_digest: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, src)
    from repro_torch.kernels.block_agg import block_agg, block_agg_batched
    from repro_torch.kernels.filtered_agg import filtered_agg, filtered_agg_batched

    dev = torch.device("cuda")
    n_blocks = 4096
    digests = {f.__name__: hashlib.sha256()
               for f in (filtered_agg, block_agg, filtered_agg_batched, block_agg_batched)}
    launches = dict.fromkeys(digests, 0)

    def add(name, out):
        torch.cuda.synchronize()
        digests[name].update(out.contiguous().view(torch.int32).cpu().numpy().tobytes())
        launches[name] += 1

    for br in (32, 100, 256):
        rng = np.random.default_rng(br)
        n = n_blocks * br
        t = lambda a: torch.from_numpy(a).to(dev)
        price = t(rng.uniform(900.0, 1100.0, n).astype(np.float32))
        discount = t(rng.integers(0, 11, n).astype(np.float32) / np.float32(100.0))
        shipdate = t(rng.integers(0, 2526, n).astype(np.int32))
        quantity = t(rng.integers(1, 51, n).astype(np.float32))
        valid_np = rng.random(n) < 0.9
        valid_np[:br] = False                        # block 0 is empty
        valid = t(valid_np)
        column_sets = {
            "q6": (price, discount, shipdate, discount, shipdate),
            "sum": (price, None, shipdate, discount, shipdate),
            "bool x": (valid, price, shipdate, discount, shipdate),
            "f3 quantity": (price, discount, shipdate, discount, quantity),
        }
        bounds = t(np.array([100.0, 1500.0, 0.02, 0.08, 2000.0], np.float32))

        def id_row(m):
            ids = rng.integers(0, n_blocks, m).astype(np.int32)
            ids[0] = 0
            if m >= 7:
                ids[1:3] = ids[3]                    # repeated ids
                ids[-2:] = 0                         # zero padding
            return ids

        for m in (1, 7, 101, 1024, 65_536):
            ids = t(id_row(m))
            for cols in column_sets.values():
                add("filtered_agg", filtered_agg(*cols, valid, br, ids, bounds))
            for col in (price, shipdate, valid):
                add("block_agg", block_agg(col, valid, br, ids))
        for batch, m in ((3, 101), (8, 512)):
            ids = t(np.stack([id_row(m) for _ in range(batch)]))
            lo = rng.uniform(0.0, 0.03, batch)
            lane_bounds = t(np.stack([np.full(batch, 100.0), np.full(batch, 1500.0), lo,
                                      lo + 0.05, rng.uniform(500.0, 2500.0, batch)],
                                     axis=1).astype(np.float32))
            for cols in column_sets.values():
                add("filtered_agg_batched",
                    filtered_agg_batched(*cols, valid, br, ids, lane_bounds))
            for col in (price, shipdate, valid):
                add("block_agg_batched", block_agg_batched(col, valid, br, ids))
    total = hashlib.sha256()
    for name, h in digests.items():
        print(f"{name} {launches[name]} {h.hexdigest()}")
        total.update(h.digest())
    print(f"all {total.hexdigest()}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
