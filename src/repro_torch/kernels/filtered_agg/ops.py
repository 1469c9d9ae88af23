"""Wrappers of the filtered_agg CUDA kernel (``csrc/filtered_agg.cu``): one
kernel serves the solo call and the batched one.

A CUDA tensor launches the hand-written kernel, or raises; a CPU tensor runs
the plain PyTorch version (``ref.py``).  The tensors' device alone decides:
there is no mode switch and no fallback.
"""

from __future__ import annotations

from typing import Optional

import torch

from repro_torch.kernels import _build, column_launch
from repro_torch.kernels.filtered_agg.ref import (filtered_agg_batched_ref,
                                                  filtered_agg_ref)


def _check(x, y, f1, f2, f3, valid, block_rows, ids, bounds,
           batch: Optional[int] = None) -> None:
    """Columns, ids and bounds as the kernel takes them: ``batch=None`` for
    a solo call ((n,) ids, (5,) bounds), else (batch, n) ids and
    (batch, 5) bounds."""
    dev = x.device
    n = x.shape[0] if x.dim() == 1 else -1
    cols = {"x": x, "f1": f1, "f2": f2, "f3": f3, "valid": valid}
    if y is not None:
        cols["y"] = y
    for what, c in cols.items():
        if c.dim() != 1 or c.shape[0] != n or not c.is_contiguous():
            raise ValueError(f"{what}: expected a contiguous 1-D column of "
                             f"{n} rows, got shape {tuple(c.shape)}")
        if c.device != dev:
            raise ValueError(f"{what} is on {c.device}, x on {dev}")
        _build.dtype_code(c, what)
    if valid.dtype != torch.bool:
        raise TypeError(f"valid must be bool, got {valid.dtype}")
    if block_rows <= 0 or n % block_rows:
        raise ValueError(f"{n} rows are not whole blocks of {block_rows}")
    ids_dim, bounds_shape = (1, (5,)) if batch is None else (2, (batch, 5))
    if (ids.dim() != ids_dim or ids.dtype != torch.int32 or ids.device != dev
            or not ids.is_contiguous()):
        raise ValueError(f"ids must be a contiguous {ids_dim}-D int32 tensor "
                         "on the columns' device")
    if (tuple(bounds.shape) != bounds_shape or bounds.dtype != torch.float32
            or bounds.device != dev or not bounds.is_contiguous()):
        raise ValueError(f"bounds must be a contiguous {bounds_shape} float32 "
                         "tensor on the columns' device")


def _column_args(x, y, f1, f2, f3):
    code = _build.dtype_code
    return (x.data_ptr(), code(x, "x"),
            None if y is None else y.data_ptr(),
            _build.ABSENT if y is None else code(y, "y"),
            f1.data_ptr(), code(f1, "f1"), f2.data_ptr(), code(f2, "f2"),
            f3.data_ptr(), code(f3, "f3"))


def filtered_agg(x: torch.Tensor, y: Optional[torch.Tensor], f1, f2, f3,
                 valid, block_rows: int, ids: torch.Tensor,
                 bounds: torch.Tensor) -> torch.Tensor:
    """Per sampled block: ``(count, SUM x*y, SUM (x*y)^2)`` over rows with
    ``lo1<=f1<=hi1 AND lo2<=f2<=hi2 AND f3<c3 AND valid``; (n_phys, 3) f32.

    Columns are 1-D in their stored dtype (f32, int32 or bool) and compared
    in f32; ``y=None`` means SUM(x).  ``ids`` (int32) may hold repeats and
    the zero padding of ``pad_block_ids``; ``bounds`` is the (5,) f32 device
    vector ``(lo1, hi1, lo2, hi2, c3)``.  Ids must lie in
    ``[0, num_blocks)``: the caller checks them on the host.
    """
    _check(x, y, f1, f2, f3, valid, block_rows, ids, bounds)
    _build.count(filtered_agg, "calls")
    if x.device.type == "cpu":
        return filtered_agg_ref(x, y, f1, f2, f3, valid, block_rows, ids, bounds)
    if x.device.type != "cuda":
        raise ValueError(f"filtered_agg runs on cuda or cpu, not {x.device}")
    k = column_launch.blocks_per_warp(ids.shape[0], _build.sm_count(x.device.index))
    return _launch(x, y, f1, f2, f3, valid, block_rows, ids, bounds, k)


def launch(x: torch.Tensor, y: Optional[torch.Tensor], f1, f2, f3, valid,
           block_rows: int, ids: torch.Tensor, bounds: torch.Tensor,
           blocks_per_warp: int) -> torch.Tensor:
    """The CUDA launch of :func:`filtered_agg` ((n_phys,) ids, (5,) bounds)
    or of :func:`filtered_agg_batched` ((B, n_phys) ids, (B, 5) bounds) with
    ``blocks_per_warp`` sampled blocks per warp (one of
    ``column_launch.BLOCKS_PER_WARP``); the output is bitwise the same for
    each.  The wrappers pick it from the launch's size; a caller names it
    only to compare or time the choices."""
    batch = ids.shape[0] if ids.dim() == 2 else None
    _check(x, y, f1, f2, f3, valid, block_rows, ids, bounds, batch=batch)
    if batch is not None and not 1 <= batch <= _build.MAX_BATCH:
        raise ValueError(f"batch {batch} outside [1, {_build.MAX_BATCH}]")
    if x.device.type != "cuda":
        raise ValueError(f"filtered_agg launches on cuda, not {x.device}")
    if blocks_per_warp not in column_launch.BLOCKS_PER_WARP:
        raise ValueError(f"blocks_per_warp {blocks_per_warp} not in "
                         f"{column_launch.BLOCKS_PER_WARP}")
    return _launch(x, y, f1, f2, f3, valid, block_rows, ids, bounds,
                   blocks_per_warp)


def _launch(x, y, f1, f2, f3, valid, block_rows, ids, bounds,
            blocks_per_warp):
    """One launch of the kernel over every id row of ``ids`` (1-D: one
    row), counted on the wrapper whose call it serves."""
    lib = _build.load("filtered_agg")
    batch, n_phys = (1, ids.shape[0]) if ids.dim() == 1 else ids.shape
    out = torch.empty((*ids.shape, 3), dtype=torch.float32, device=x.device)
    with torch.cuda.device(x.device):
        rc = lib.filtered_agg_launch(
            *_column_args(x, y, f1, f2, f3), valid.data_ptr(), ids.data_ptr(),
            batch, n_phys, block_rows, blocks_per_warp, bounds.data_ptr(),
            out.data_ptr(), torch.cuda.current_stream(x.device).cuda_stream)
    _build.check(lib, "filtered_agg", rc)
    _build.count(filtered_agg if ids.dim() == 1 else filtered_agg_batched,
                 "launches")
    return out


def filtered_agg_batched(x: torch.Tensor, y: Optional[torch.Tensor], f1, f2,
                         f3, valid, block_rows: int, ids: torch.Tensor,
                         bounds: torch.Tensor) -> torch.Tensor:
    """:func:`filtered_agg` for B lanes in ONE launch: lane b reads id row
    ``ids[b]`` ((B, n_phys) int32) and bounds row ``bounds[b]`` ((B, 5)
    f32); returns (B, n_phys, 3) f32, each lane bitwise the solo call on
    its row (the same kernel, launched over B id rows).  Ids must lie in
    ``[0, num_blocks)``: the caller checks them on the host.
    """
    batch = ids.shape[0] if ids.dim() == 2 else -1
    _check(x, y, f1, f2, f3, valid, block_rows, ids, bounds, batch=batch)
    if not 1 <= batch <= _build.MAX_BATCH:
        raise ValueError(f"batch {batch} outside [1, {_build.MAX_BATCH}]")
    _build.count(filtered_agg_batched, "calls")
    if x.device.type == "cpu":
        return filtered_agg_batched_ref(x, y, f1, f2, f3, valid, block_rows,
                                        ids, bounds)
    if x.device.type != "cuda":
        raise ValueError(
            f"filtered_agg_batched runs on cuda or cpu, not {x.device}")
    k = column_launch.blocks_per_warp(ids.shape[1], _build.sm_count(x.device.index),
                                      batch)
    return _launch(x, y, f1, f2, f3, valid, block_rows, ids, bounds, k)


# ``calls`` counts every call on either device; ``launches`` counts CUDA
# kernel launches only.  Plain integers, bumped under ``_build.count``'s
# lock: a run resets and reads them.
filtered_agg.calls = 0
filtered_agg.launches = 0
filtered_agg_batched.calls = 0
filtered_agg_batched.launches = 0
