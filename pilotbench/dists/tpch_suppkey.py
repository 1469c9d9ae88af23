"""``tpch_suppkey``: dbgen's supplier of a line (``PART_SUPP_BRIDGE``): one
of the ``suppliers_per_part`` suppliers of the part key ``partkey``, drawn
uniformly, among ``suppliers`` in all."""

import torch


def make(spec, ctx):
    p = ctx.cols[spec["partkey"]].long()
    s_total, per = int(spec["suppliers"]), int(spec["suppliers_per_part"])
    s = torch.randint(0, per, (ctx.rows,), generator=ctx.g, device=ctx.device,
                      dtype=torch.int64)
    return (p + s * (s_total // per + (p - 1) // s_total)) % s_total + 1
