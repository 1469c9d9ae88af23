"""Plain PyTorch version of filtered_agg (the CPU route and the kernel's
yardstick in tests and ``chip_smoke.py``)."""

from __future__ import annotations

from typing import Optional

import torch


def filtered_agg_ref(x, y: Optional[torch.Tensor], f1, f2, f3, valid,
                     block_rows: int, ids, bounds) -> torch.Tensor:
    """Same function as the kernel: 1-D columns, (n_phys,) int32 ids, (5,) f32
    bounds ``(lo1, hi1, lo2, hi2, c3)``; returns (n_phys, 3) f32
    ``(count, SUM x*y, SUM (x*y)^2)`` over kept rows.  ``y=None`` is 1.0.

    Only the sampled blocks are gathered, then widened to f32, so the cost
    is theta * bytes like the kernel's."""
    idx = ids.long()

    def rows(col):
        return col.view(-1, block_rows)[idx].to(torch.float32)

    lo1, hi1, lo2, hi2, c3 = bounds.to(torch.float32).unbind()
    a1, a2, a3 = rows(f1), rows(f2), rows(f3)
    keep = ((a1 >= lo1) & (a1 <= hi1) & (a2 >= lo2) & (a2 <= hi2)
            & (a3 < c3)).to(torch.float32) * rows(valid)
    prod = rows(x) if y is None else rows(x) * rows(y)
    return torch.stack([keep.sum(dim=1), (prod * keep).sum(dim=1),
                        (prod * prod * keep).sum(dim=1)], dim=1)
