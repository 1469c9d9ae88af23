"""Plain PyTorch version of block_agg (the CPU route and the kernel's
yardstick in tests and ``chip_smoke.py``)."""

from __future__ import annotations

import torch


def block_agg_ref(values, valid, block_rows: int, ids) -> torch.Tensor:
    """Same function as the kernel: 1-D value and validity columns, (n_phys,)
    int32 ids; returns (n_phys, 5) f32 ``(count, sum, sumsq, min, max)`` over
    valid rows, with min = max = NaN for a block with no valid row."""
    idx = ids.long()
    v = values.view(-1, block_rows)[idx].to(torch.float32)
    m = valid.view(-1, block_rows)[idx].to(torch.float32)
    cnt = m.sum(dim=1)
    big = torch.tensor(3.4e38, dtype=torch.float32, device=v.device)
    nan = torch.tensor(float("nan"), dtype=torch.float32, device=v.device)
    mn = torch.where(cnt > 0, torch.where(m > 0, v, big).amin(dim=1), nan)
    mx = torch.where(cnt > 0, torch.where(m > 0, v, -big).amax(dim=1), nan)
    return torch.stack([cnt, (v * m).sum(dim=1), (v * v * m).sum(dim=1), mn, mx],
                       dim=1)
