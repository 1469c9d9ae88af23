"""The unfiltered SUM and COUNT of ``lineitem``: a whole-table total, the
cheapest query a dashboard asks."""

import torch

TABLE = "lineitem"
SQL = "SELECT SUM(l_extendedprice) AS s, COUNT(*) AS n FROM lineitem"
COLUMNS = ("l_extendedprice",)
GROUP_BY = None
MAX_GROUPS = 1
CHANNELS = ("s", "count")
COMPOSITES = (("s", "sum", (0,)), ("n", "count", (1,)))


def placeholders(p):
    return {}


def mask(cols, ph):
    price = cols["l_extendedprice"]
    return torch.ones(price.shape, dtype=torch.bool, device=price.device)


def values(cols, cast):
    return {"s": cast(cols["l_extendedprice"])}
