"""``position_in_run``: each row's place, from 1, in its run of equal
values of the column ``of``: dbgen's line number within an order."""

import torch


def make(spec, ctx):
    of = ctx.cols[spec["of"]]
    pos = torch.arange(ctx.rows, device=ctx.device, dtype=torch.int64)
    start = torch.zeros(ctx.rows, dtype=torch.bool, device=ctx.device)
    start[0] = True
    start[1:] = of[1:] != of[:-1]
    first = torch.where(start, pos, torch.zeros_like(pos)).cummax(0).values
    return pos - first + 1
