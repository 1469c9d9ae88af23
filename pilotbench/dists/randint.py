"""``randint``: integers uniform in ``range`` = [lo, hi), one a row, or with
``"per": <column>`` one for each value 0..max of that column, read back at
each row's value (an attribute of a parent, such as an order's date); then
``"plus": <column>`` adds an earlier column and ``"divide"`` divides."""

import torch


def make(spec, ctx):
    lo, hi = spec["range"]
    n = ctx.rows
    if "per" in spec:
        parent = ctx.cols[spec["per"]]
        n = int(parent.max()) + 1
    v = torch.randint(int(lo), int(hi), (n,), generator=ctx.g, device=ctx.device,
                      dtype=torch.int64)
    if "per" in spec:
        v = v[parent.to(torch.int64)]
    if "plus" in spec:
        v = v + ctx.cols[spec["plus"]].to(torch.int64)
    if "divide" in spec:
        v = v.to(torch.float64) / float(spec["divide"])
    return v
