"""``date_code``: a code that follows a date column: where ``of`` is at
most ``at_most``, one of ``then`` (uniformly), else one of ``else``.
dbgen's rules against its CURRENTDATE: ``l_returnflag`` is R or A once the
receipt date has passed and N before; ``l_linestatus`` is F once the ship
date has passed and O before."""

import torch


def _pick(codes, ctx):
    codes = torch.as_tensor(codes, dtype=torch.int64, device=ctx.device)
    if codes.numel() == 1:
        return codes.expand(ctx.rows)
    i = torch.randint(0, codes.numel(), (ctx.rows,), generator=ctx.g,
                      device=ctx.device, dtype=torch.int64)
    return codes[i]


def make(spec, ctx):
    past = ctx.cols[spec["of"]] <= int(spec["at_most"])
    return torch.where(past, _pick(spec["then"], ctx), _pick(spec["else"], ctx))
