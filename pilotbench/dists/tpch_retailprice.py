"""``tpch_retailprice``: dbgen's ``p_retailprice`` of the part key ``of``
(``rpb_routine``: 90,000 + (key / 10) mod 20,001 + 100 (key mod 1,000), in
cents), the price that ``tpch_extendedprice`` multiplies by the quantity."""

import torch


def make(spec, ctx):
    p = ctx.cols[spec["of"]].long()
    cents = 90000 + (p // 10) % 20001 + 100 * (p % 1000)
    return cents.to(torch.float64) / 100.0
