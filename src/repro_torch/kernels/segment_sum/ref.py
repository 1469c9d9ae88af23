"""Plain PyTorch version of segment_sum (the CPU route and the kernel's
yardstick in tests and ``chip_smoke.py``)."""

from __future__ import annotations

from typing import Optional

import torch


def _check_slab_claim(seg: torch.Tensor, num_segments: int, slab_rows: int,
                     slab_keys: int) -> None:
    """Raise ``ValueError`` unless every row r whose key lies in
    ``[0, num_segments)`` has ``key // slab_keys == r // slab_rows``."""
    keep = (seg >= 0) & (seg < num_segments)
    row = torch.arange(seg.shape[0], device=seg.device)
    bad = keep & (torch.div(seg, slab_keys, rounding_mode="floor")
                  != torch.div(row, slab_rows, rounding_mode="floor"))
    if bool(bad.any()):
        r = int(bad.nonzero()[0, 0])
        key = int(seg[r])
        raise ValueError(
            f"slab claim broken: row {r} (slab {r // slab_rows} of {slab_rows} rows) "
            f"has key {key}, which belongs to slab {key // slab_keys} of {slab_keys} keys")


def segment_sum_ref(vals: torch.Tensor, seg: torch.Tensor, num_segments: int, *,
                    slab_rows: Optional[int] = None,
                    slab_keys: Optional[int] = None) -> torch.Tensor:
    """Same function as the kernels: (C, S) f32 with ``out[c, s]`` the sum of
    ``vals[c, r]`` over the rows with ``seg[r] == s``; a row whose key lies
    outside ``[0, num_segments)`` is dropped, as the kernels drop it.  A slab
    claim (``slab_rows`` and ``slab_keys``) is checked, and a false one
    raises.  On the CPU ``index_add_`` adds the rows in row order, as the
    reference's XLA scatter-add does."""
    if slab_rows is not None:
        _check_slab_claim(seg, num_segments, slab_rows, slab_keys)
    out = torch.zeros((vals.shape[0], num_segments), dtype=torch.float32,
                      device=vals.device)
    keep = (seg >= 0) & (seg < num_segments)
    if not bool(keep.all()):
        vals, seg = vals[:, keep], seg[keep]
    return out.index_add_(1, seg, vals)
