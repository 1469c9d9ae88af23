"""Wrapper of the segment_sum CUDA kernel (``csrc/segment_sum.cu``).

A CUDA tensor launches the hand-written kernel, or raises; a CPU tensor runs
the plain PyTorch version (``ref.py``).  The tensors' device alone decides:
there is no mode switch and no fallback.
"""

from __future__ import annotations

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.segment_sum.ref import segment_sum_ref

MAX_SEGMENTS = 2 ** 31 - 1  # keys travel as int32 through the sort


def chunk_rows(rows: int) -> int:
    """Sorted positions per tile, and at most per chunk, of a call over
    ``rows`` rows: 1,024 up to 2^24 rows, 4,096 above (csrc ``chunk``).  A
    function of the row count alone, so a call's bits depend on its inputs
    alone."""
    return 4096 if rows > 1 << 24 else 1024


def _check(vals: torch.Tensor, seg: torch.Tensor, num_segments: int) -> None:
    if vals.dim() != 2 or vals.dtype != torch.float32 or not vals.is_contiguous():
        raise ValueError("vals must be a contiguous (C, R) float32 tensor, got "
                         f"{vals.dtype} {tuple(vals.shape)}")
    if (seg.dim() != 1 or seg.dtype != torch.int64 or not seg.is_contiguous()
            or seg.shape[0] != vals.shape[1]):
        raise ValueError(f"seg must be a contiguous ({vals.shape[1]},) int64 "
                         f"tensor, got {seg.dtype} {tuple(seg.shape)}")
    if seg.device != vals.device:
        raise ValueError(f"seg is on {seg.device}, vals on {vals.device}")
    if not 0 <= num_segments <= MAX_SEGMENTS:
        raise ValueError(f"num_segments {num_segments} outside [0, {MAX_SEGMENTS}]")


def segment_sum(vals: torch.Tensor, seg: torch.Tensor,
                num_segments: int) -> torch.Tensor:
    """Per-segment channel sums: ``vals`` (C, R) f32 and ``seg`` (R,) int64
    keys in ``[0, num_segments)`` give (C, num_segments) f32, zero where no
    row has the key.  The sums are added in an order fixed by the keys (row
    order within each chunk of :func:`chunk_rows` rows of a segment, chunks
    in order), so the output is the same bits run to run; a row whose key
    lies outside the range is dropped, on either device."""
    _check(vals, seg, num_segments)
    _build.count(segment_sum, "calls")
    if vals.device.type == "cpu":
        return segment_sum_ref(vals, seg, num_segments)
    if vals.device.type != "cuda":
        raise ValueError(f"segment_sum runs on cuda or cpu, not {vals.device}")
    return _launch(vals, seg, num_segments)


def _launch(vals, seg, num_segments):
    channels, rows = vals.shape
    dev = vals.device
    out = torch.zeros((channels, num_segments), dtype=torch.float32, device=dev)
    if rows == 0 or channels == 0 or num_segments == 0:
        return out
    lib = _build.load("segment_sum")
    chunk = chunk_rows(rows)
    tiles = -(-rows // chunk)
    # chunks: each tile's first position plus each run start inside it, at
    # most one per row
    cap = min(rows, tiles + min(rows, num_segments))
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        keys = torch.empty(rows, dtype=torch.int32, device=dev)
        rc = lib.segment_sum_keys_launch(seg.data_ptr(), rows, num_segments,
                                         keys.data_ptr(), stream)
        _build.check(lib, "segment_sum", rc)
        skeys, order = torch.sort(keys, stable=True)
        tile_count = torch.empty(tiles, dtype=torch.int32, device=dev)
        tile_first = torch.empty(tiles + 1, dtype=torch.int64, device=dev)
        chunk_start = torch.empty(cap, dtype=torch.int64, device=dev)
        chunk_key = torch.empty(cap, dtype=torch.int32, device=dev)
        chunk_sum = torch.empty((channels, cap), dtype=torch.float32, device=dev)
        rc = lib.segment_sum_launch(
            vals.data_ptr(), order.data_ptr(), skeys.data_ptr(), rows, chunk, channels,
            num_segments, tile_count.data_ptr(), tile_first.data_ptr(),
            chunk_start.data_ptr(), chunk_key.data_ptr(), chunk_sum.data_ptr(),
            cap, out.data_ptr(), stream)
    _build.check(lib, "segment_sum", rc)
    _build.count(segment_sum, "launches")
    return out


# ``calls`` counts every call on either device; ``launches`` counts CUDA
# kernel launches only.  Plain integers, bumped under ``_build.count``'s
# lock: a run resets and reads them.
segment_sum.calls = 0
segment_sum.launches = 0
