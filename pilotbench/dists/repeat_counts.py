"""``repeat_counts``: the index of each row's parent, where parents 0, 1,
2, ... each own a run of rows whose length is uniform in ``counts`` = [lo,
hi] (both ends in), cut at the table's rows: dbgen's 1-7 lines an order.
Enough parents are drawn that the runs always reach the table's end."""

import math

import torch


def make(spec, ctx):
    lo, hi = (int(x) for x in spec["counts"])
    mean, sd = (lo + hi) / 2.0, math.sqrt(((hi - lo + 1) ** 2 - 1) / 12.0)
    parents = math.ceil(ctx.rows / mean)
    parents += math.ceil(12 * sd * math.sqrt(parents) / mean) + 16
    counts = torch.randint(lo, hi + 1, (parents,), generator=ctx.g, device=ctx.device,
                           dtype=torch.int64)
    total = int(counts.sum())
    if total < ctx.rows:
        raise ValueError(f"repeat_counts: {total} rows from {parents} parents, "
                         f"{ctx.rows} wanted")
    idx = torch.arange(parents, device=ctx.device).repeat_interleave(
        counts, output_size=total)
    return idx[:ctx.rows]
