"""``tpch_extendedprice``: dbgen's ``l_extendedprice``: the quantity
``times`` the retail price of the part ``partkey`` (``rpb_routine``: 90,000
+ (key / 10) mod 20,001 + 100 (key mod 1,000), in cents)."""

import torch


def make(spec, ctx):
    p = ctx.cols[spec["partkey"]].long()
    cents = 90000 + (p // 10) % 20001 + 100 * (p % 1000)
    return ctx.cols[spec["times"]].to(torch.float64) * cents.to(torch.float64) / 100.0
