"""Wrappers of the block_agg CUDA kernel (``csrc/block_agg.cu``): one kernel
serves the solo call and the batched one.

A CUDA tensor launches the hand-written kernel, or raises; a CPU tensor runs
the plain PyTorch version (``ref.py``).  The tensors' device alone decides:
there is no mode switch and no fallback.
"""

from __future__ import annotations

import torch

from repro_torch.kernels import _build, column_launch
from repro_torch.kernels.block_agg.ref import block_agg_batched_ref, block_agg_ref


def _check(values, valid, block_rows, ids, ids_dim: int = 1) -> None:
    dev = values.device
    n = values.shape[0] if values.dim() == 1 else -1
    for what, c in (("values", values), ("valid", valid)):
        if c.dim() != 1 or c.shape[0] != n or not c.is_contiguous():
            raise ValueError(f"{what}: expected a contiguous 1-D column of "
                             f"{n} rows, got shape {tuple(c.shape)}")
        if c.device != dev:
            raise ValueError(f"{what} is on {c.device}, values on {dev}")
        _build.dtype_code(c, what)
    if valid.dtype != torch.bool:
        raise TypeError(f"valid must be bool, got {valid.dtype}")
    if block_rows <= 0 or n % block_rows:
        raise ValueError(f"{n} rows are not whole blocks of {block_rows}")
    if (ids.dim() != ids_dim or ids.dtype != torch.int32 or ids.device != dev
            or not ids.is_contiguous()):
        raise ValueError(f"ids must be a contiguous {ids_dim}-D int32 tensor "
                         "on the columns' device")


def block_agg(values: torch.Tensor, valid: torch.Tensor, block_rows: int,
              ids: torch.Tensor) -> torch.Tensor:
    """Per sampled block: ``(count, sum, sumsq, min, max)`` of ``values`` over
    valid rows; (n_phys, 5) f32.  A block with no valid row reports
    min = max = NaN (mask them on count > 0).

    ``values`` is 1-D in its stored dtype (f32, int32, or bool — a COUNT-only
    query passes the validity column itself); ``valid`` is bool; ``ids``
    (int32, in ``[0, num_blocks)``, checked by the caller) may hold repeats
    and the zero padding of ``pad_block_ids``.
    """
    _check(values, valid, block_rows, ids)
    _build.count(block_agg, "calls")
    if values.device.type == "cpu":
        return block_agg_ref(values, valid, block_rows, ids)
    if values.device.type != "cuda":
        raise ValueError(f"block_agg runs on cuda or cpu, not {values.device}")
    k = column_launch.blocks_per_warp(ids.shape[0], _build.sm_count(values.device.index))
    return _launch(values, valid, block_rows, ids, k)


def launch(values: torch.Tensor, valid: torch.Tensor, block_rows: int,
           ids: torch.Tensor, blocks_per_warp: int) -> torch.Tensor:
    """The CUDA launch of :func:`block_agg` ((n_phys,) ids) or of
    :func:`block_agg_batched` ((B, n_phys) ids) with ``blocks_per_warp``
    sampled blocks per warp (one of ``column_launch.BLOCKS_PER_WARP``); the
    output is bitwise the same for each.  The wrappers pick it from the
    launch's size; a caller names it only to compare or time the choices."""
    _check(values, valid, block_rows, ids, ids_dim=2 if ids.dim() == 2 else 1)
    if ids.dim() == 2 and not 1 <= ids.shape[0] <= _build.MAX_BATCH:
        raise ValueError(f"batch {ids.shape[0]} outside [1, {_build.MAX_BATCH}]")
    if values.device.type != "cuda":
        raise ValueError(f"block_agg launches on cuda, not {values.device}")
    if blocks_per_warp not in column_launch.BLOCKS_PER_WARP:
        raise ValueError(f"blocks_per_warp {blocks_per_warp} not in "
                         f"{column_launch.BLOCKS_PER_WARP}")
    return _launch(values, valid, block_rows, ids, blocks_per_warp)


def _launch(values, valid, block_rows, ids, blocks_per_warp):
    """One launch of the kernel over every id row of ``ids`` (1-D: one
    row), counted on the wrapper whose call it serves."""
    lib = _build.load("block_agg")
    batch, n_phys = (1, ids.shape[0]) if ids.dim() == 1 else ids.shape
    out = torch.empty((*ids.shape, 5), dtype=torch.float32, device=values.device)
    with torch.cuda.device(values.device):
        rc = lib.block_agg_launch(
            values.data_ptr(), _build.dtype_code(values, "values"),
            valid.data_ptr(), ids.data_ptr(), batch, n_phys, block_rows,
            blocks_per_warp, out.data_ptr(),
            torch.cuda.current_stream(values.device).cuda_stream)
    _build.check(lib, "block_agg", rc)
    _build.count(block_agg if ids.dim() == 1 else block_agg_batched, "launches")
    return out


def block_agg_batched(values: torch.Tensor, valid: torch.Tensor,
                      block_rows: int, ids: torch.Tensor) -> torch.Tensor:
    """:func:`block_agg` for B lanes in ONE launch: lane b reads id row
    ``ids[b]`` ((B, n_phys) int32); returns (B, n_phys, 5) f32 with the NaN
    sentinel for empty blocks, each lane bitwise the solo call on its row
    (the same kernel, launched over B id rows).  Ids must lie in
    ``[0, num_blocks)``: the caller checks them on the host.
    """
    _check(values, valid, block_rows, ids, ids_dim=2)
    batch = ids.shape[0]
    if not 1 <= batch <= _build.MAX_BATCH:
        raise ValueError(f"batch {batch} outside [1, {_build.MAX_BATCH}]")
    _build.count(block_agg_batched, "calls")
    if values.device.type == "cpu":
        return block_agg_batched_ref(values, valid, block_rows, ids)
    if values.device.type != "cuda":
        raise ValueError(
            f"block_agg_batched runs on cuda or cpu, not {values.device}")
    k = column_launch.blocks_per_warp(
        ids.shape[1], _build.sm_count(values.device.index), batch)
    return _launch(values, valid, block_rows, ids, k)


# ``calls`` counts every call on either device; ``launches`` counts CUDA
# kernel launches only.  Plain integers, bumped under ``_build.count``'s
# lock: a run resets and reads them.
block_agg.calls = 0
block_agg.launches = 0
block_agg_batched.calls = 0
block_agg_batched.launches = 0
