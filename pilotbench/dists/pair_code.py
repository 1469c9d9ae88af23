"""``pair_code``: one code for a pair of code columns ``of``: the place of
the row's pair in ``pairs`` (a pair not listed reads -1), so that a GROUP BY
of one column groups by both."""

import torch


def make(spec, ctx):
    a, b = (ctx.cols[c].long() for c in spec["of"])
    out = torch.full((ctx.rows,), -1, dtype=torch.int64, device=ctx.device)
    for k, (x, y) in enumerate(spec["pairs"]):
        out[(a == int(x)) & (b == int(y))] = k
    return out
