"""Wrapper of the block_draw CUDA kernel (``csrc/block_draw.cu``): the
Bernoulli block draw of TABLESAMPLE SYSTEM on the card, bitwise
``engine/sampling.py``'s host draw.

A CUDA device launches the hand-written kernel, or raises; the CPU runs the
plain version (``ref.py``).  The device alone decides: there is no mode
switch and no fallback.  The wrapper does not synchronise: the count and the
ids stay on the card, and the caller reads the count when it needs it.
"""

from __future__ import annotations

import threading
from typing import Dict, Tuple

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.block_draw.ref import block_draw_ref

THREADS = 256                 # a CTA (csrc kThreads)
CHUNK = 16                    # consecutive indices a thread draws (csrc kChunk)
TILE = THREADS * CHUNK        # indices a CTA draws (csrc kTile)
MAX_BLOCKS = 2 ** 31 - 1      # ids travel as int32
_MASK64 = (1 << 64) - 1

_scratch_lock = threading.Lock()
_scratch: Dict[Tuple[int, int], torch.Tensor] = {}


def _draw_scratch(dev: torch.device, stream: int, tiles: int) -> torch.Tensor:
    """The look-back's scratch of (device, stream), with a status word for
    at least ``tiles`` tiles: epoch 1, ticket 0, no status published.  It is
    made on the card at its first use and again, larger, when a larger
    table comes (the old one's last launch runs first, on the same stream).
    Each launch advances the epoch on the card and leaves the ticket at
    zero; launches on one stream never overlap, and PyTorch's streams live
    as long as the process, so a key is never another stream's."""
    key = (dev.index, stream)
    with _scratch_lock:
        buf = _scratch.get(key)
        if buf is None or buf.shape[0] - 2 < tiles:
            buf = torch.zeros(2 + tiles, dtype=torch.int64, device=dev)
            buf[0] = 1 << 32
            _scratch[key] = buf
        return buf


def block_draw(num_blocks: int, rate: float, state: int,
               inc: int, device) -> Tuple[torch.Tensor, torch.Tensor]:
    """Keep block i of ``num_blocks`` where uniform i of the PCG64 stream
    ``(state, inc)`` (``ref.pcg64_state(seed)``: ``default_rng(seed)``'s)
    lies below ``rate``, compared in f64 as numpy compares.

    Returns ``count`` (1,) int32 and ``ids`` (num_blocks,) int32 on
    ``device``: the kept ids in ascending order, then zeros up to the
    draw's padded length (``sampling.pad_block_ids``'s ``n_phys``, a
    function of the count), and past that whatever the new tensor held.
    One launch, no copy to the card and no sync."""
    dev = torch.device(device)
    n = int(num_blocks)
    if not 0 <= n <= MAX_BLOCKS:
        raise ValueError(f"{n} blocks, at most {MAX_BLOCKS}")
    if not (0 <= state < 1 << 128 and 0 <= inc < 1 << 128):
        raise ValueError("state and inc are 128-bit unsigned integers")
    _build.count(block_draw, "calls")
    if dev.type == "cpu":
        return block_draw_ref(n, float(rate), state, inc)
    if dev.type != "cuda":
        raise ValueError(f"block_draw runs on cuda or cpu, not {dev}")
    if dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    ids = torch.empty(n, dtype=torch.int32, device=dev)
    if n == 0:
        return torch.zeros(1, dtype=torch.int32, device=dev), ids
    count = torch.empty(1, dtype=torch.int32, device=dev)  # the last tile writes it
    tiles = -(-n // TILE)
    lib = _build.load("block_draw")
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        scratch = _draw_scratch(dev, stream, tiles)
        rc = lib.block_draw_launch(
            state >> 64, state & _MASK64, inc >> 64, inc & _MASK64, float(rate), n,
            scratch.data_ptr(), scratch.shape[0] - 2, ids.data_ptr(), count.data_ptr(),
            stream)
    _build.check(lib, "block_draw", rc)
    _build.count(block_draw, "launches")
    return count, ids


# ``calls`` counts every call on either device; ``launches`` counts CUDA
# launches only, one kernel a call.  Plain integers, bumped under
# ``_build.count``'s lock: a run resets and reads them.
block_draw.calls = 0
block_draw.launches = 0
