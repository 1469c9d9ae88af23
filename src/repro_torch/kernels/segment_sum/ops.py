"""Wrapper of the segment_sum CUDA kernels (``csrc/segment_sum.cu``).

A CUDA tensor launches the hand-written kernels, or raises; a CPU tensor runs
the plain PyTorch version (``ref.py``).  The tensors' device alone decides:
there is no mode switch and no fallback.  On the card, :func:`launch_plan`
picks one of three routes from the call's shape and slab claim alone.
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.segment_sum.ref import segment_sum_ref

MAX_SEGMENTS = 2 ** 31 - 1  # keys travel as int32 through the sorted route's sort
FEW_SLOTS = 4_096           # the few route takes S * C up to this many sums
LANE_KEYS = 4               # few route: S up to this, sums in registers (csrc kLaneKeys)
SLAB_LANE_KEYS = 32         # slab route: W up to this, keys held in lanes (kSlabLaneKeys)
_WARPS_PER_CTA = 8          # csrc kWarpsPerCta


class LaunchPlan(NamedTuple):
    """What one call runs on the card: its route, the variant of that
    route's kernel, and the CTA count of each launch (the sorted route's
    ``torch.sort`` not counted)."""
    route: str
    variant: str
    grids: Tuple[int, ...]


def chunk_rows(rows: int) -> int:
    """Sorted positions per tile, and at most per chunk, of a sorted-route
    call over ``rows`` rows: 1,024 up to 2^24 rows, 4,096 above (csrc
    ``chunk``).  A function of the row count alone, so a call's bits depend
    on its inputs alone."""
    return 4096 if rows > 1 << 24 else 1024


def range_rows(rows: int) -> int:
    """Rows per range of a few-route call over ``rows`` rows: the least
    power of two, at least 256, that cuts them into at most 4,096 ranges.  A
    function of the row count alone."""
    per = -(-rows // 4096)
    return max(256, 1 << max(per - 1, 0).bit_length())


def _warp_ctas(warps: int) -> int:
    return -(-warps // _WARPS_PER_CTA)


def launch_plan(channels: int, rows: int, num_segments: int,
                slab_rows: Optional[int] = None,
                slab_keys: Optional[int] = None,
                force: Optional[str] = None) -> LaunchPlan:
    """The route, variant and launch grids of a call, from its shape and
    slab claim alone: ``slab`` where the caller makes a slab claim, else
    ``few`` where S * C <= FEW_SLOTS, else ``sorted``.  ``force`` names
    another route, for checks and timing only (the slab route needs the
    claim)."""
    r = force or ("slab" if slab_rows is not None else
                  "few" if num_segments * channels <= FEW_SLOTS else "sorted")
    if r == "slab":
        if slab_rows is None:
            raise ValueError("the slab route needs slab_rows and slab_keys")
        lanes = slab_keys <= SLAB_LANE_KEYS
        slabs = -(-rows // slab_rows)
        if lanes:
            slabs = max(slabs, -(-num_segments // slab_keys))
        return LaunchPlan("slab", "lane" if lanes else "wide", (_warp_ctas(slabs),))
    if r == "few":
        if num_segments * channels > FEW_SLOTS:
            raise ValueError(f"the few route takes S * C <= {FEW_SLOTS}, got "
                             f"{num_segments} x {channels}")
        ranges = -(-rows // range_rows(rows))
        return LaunchPlan("few", "lane" if num_segments <= LANE_KEYS else "warp",
                          (_warp_ctas(ranges), num_segments * channels))
    if r != "sorted":
        raise ValueError(f"route {r!r} is none of slab, few, sorted")
    tiles = -(-rows // chunk_rows(rows))
    cap = min(rows, tiles + min(rows, num_segments))
    return LaunchPlan("sorted", "sorted",
                      (min(-(-rows // 256), 65_536), _warp_ctas(tiles), 1,
                       _warp_ctas(tiles), min(_warp_ctas(cap), 4096),
                       min(_warp_ctas(cap), 4096)))


def _check(vals: torch.Tensor, seg: torch.Tensor, num_segments: int,
           slab_rows: Optional[int], slab_keys: Optional[int]) -> None:
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
    if (slab_rows is None) != (slab_keys is None):
        raise ValueError("a slab claim gives both slab_rows and slab_keys")
    if slab_rows is not None and (slab_rows < 1 or slab_keys < 1):
        raise ValueError(f"slab_rows {slab_rows} and slab_keys {slab_keys} must be >= 1")


def segment_sum(vals: torch.Tensor, seg: torch.Tensor, num_segments: int, *,
                slab_rows: Optional[int] = None,
                slab_keys: Optional[int] = None) -> torch.Tensor:
    """Per-segment channel sums: ``vals`` (C, R) f32 and ``seg`` (R,) int64
    keys in ``[0, num_segments)`` give (C, num_segments) f32, zero where no
    row has the key; a row whose key lies outside the range is dropped, on
    either device.

    ``slab_rows`` and ``slab_keys`` (W) together make the slab claim: every
    row r with a key in range has ``key // W == r // slab_rows``.  The plain
    version checks it and raises where it fails; on the card it sends the
    call to the slab route.

    On the card the sums are added in an order fixed by the inputs, so the
    output is the same bits run to run: the slab route adds each key's rows
    of a 32-row step by a fixed butterfly over the lanes and the steps in
    row order; the few route adds lane-strided rows of fixed row ranges
    (:func:`range_rows`) in row order, then the lanes and the ranges in a
    fixed order; the sorted route the rows of each chunk of
    :func:`chunk_rows` sorted positions in row order, then the chunks in
    order (csrc header).  On the CPU ``index_add_`` adds in row order."""
    _check(vals, seg, num_segments, slab_rows, slab_keys)
    _build.count(segment_sum, "calls")
    if vals.device.type == "cpu":
        return segment_sum_ref(vals, seg, num_segments, slab_rows=slab_rows,
                               slab_keys=slab_keys)
    if vals.device.type != "cuda":
        raise ValueError(f"segment_sum runs on cuda or cpu, not {vals.device}")
    return launch(vals, seg, num_segments, slab_rows=slab_rows, slab_keys=slab_keys)


def launch(vals: torch.Tensor, seg: torch.Tensor, num_segments: int, *,
           slab_rows: Optional[int] = None, slab_keys: Optional[int] = None,
           force: Optional[str] = None) -> torch.Tensor:
    """The CUDA launch of :func:`segment_sum` (checked inputs on the card);
    ``force`` runs another route than the call's own, for checks and timing
    only."""
    channels, rows = vals.shape
    dev = vals.device
    if rows == 0 or channels == 0 or num_segments == 0:
        return torch.zeros((channels, num_segments), dtype=torch.float32, device=dev)
    plan = launch_plan(channels, rows, num_segments, slab_rows, slab_keys, force)
    lib = _build.load("segment_sum")
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        if plan.route == "slab":
            lanes = plan.variant == "lane"
            out = (torch.empty if lanes else torch.zeros)(
                (channels, num_segments), dtype=torch.float32, device=dev)
            rc = lib.segment_sum_slab_launch(
                vals.data_ptr(), seg.data_ptr(), rows, channels, num_segments,
                slab_rows, slab_keys, int(lanes), out.data_ptr(), stream)
        elif plan.route == "few":
            rr = range_rows(rows)
            out = torch.empty((channels, num_segments), dtype=torch.float32, device=dev)
            partial = torch.empty((channels * num_segments, -(-rows // rr)),
                                  dtype=torch.float32, device=dev)
            rc = lib.segment_sum_few_launch(
                vals.data_ptr(), seg.data_ptr(), rows, channels, num_segments, rr,
                int(plan.variant == "lane"), partial.data_ptr(), out.data_ptr(), stream)
        else:
            out = _sorted(lib, vals, seg, num_segments, stream)
            rc = 0
    _build.check(lib, "segment_sum", rc)
    _build.count(segment_sum, "launches")
    return out


def _sorted(lib, vals, seg, num_segments, stream):
    """The sorted route: int32 keys, a stable sort, then six passes."""
    channels, rows = vals.shape
    dev = vals.device
    out = torch.zeros((channels, num_segments), dtype=torch.float32, device=dev)
    chunk = chunk_rows(rows)
    tiles = -(-rows // chunk)
    # chunks: each tile's first position plus each run start inside it, at
    # most one per row
    cap = min(rows, tiles + min(rows, num_segments))
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
    return out


# ``calls`` counts every call on either device; ``launches`` counts CUDA
# launches only (one per call, whatever its route; ``launch`` with
# ``force`` counts too).  Plain integers, bumped under ``_build.count``'s
# lock: a run resets and reads them.
segment_sum.calls = 0
segment_sum.launches = 0
