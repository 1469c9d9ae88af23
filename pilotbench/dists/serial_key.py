"""``serial_key``: the keys 1, 2, ..., one a row in order: dbgen's dense
primary keys, such as ``p_partkey`` 1..SF x 200,000."""

import torch


def make(spec, ctx):
    return torch.arange(1, ctx.rows + 1, device=ctx.device, dtype=torch.int64)
