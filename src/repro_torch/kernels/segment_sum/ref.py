"""Plain PyTorch version of segment_sum (the CPU route and the kernel's
yardstick in tests and ``chip_smoke.py``)."""

from __future__ import annotations

import torch


def segment_sum_ref(vals: torch.Tensor, seg: torch.Tensor,
                    num_segments: int) -> torch.Tensor:
    """Same function as the kernel: (C, S) f32 with ``out[c, s]`` the sum of
    ``vals[c, r]`` over the rows with ``seg[r] == s``; a row whose key lies
    outside ``[0, num_segments)`` is dropped, as the kernel drops it.  On the
    CPU ``index_add_`` adds the rows in row order, as the reference's XLA
    scatter-add does."""
    out = torch.zeros((vals.shape[0], num_segments), dtype=torch.float32,
                      device=vals.device)
    keep = (seg >= 0) & (seg < num_segments)
    if not bool(keep.all()):
        vals, seg = vals[:, keep], seg[keep]
    return out.index_add_(1, seg, vals)
