"""Wrapper of the gla_chunk CUDA kernels (``csrc/gla_chunk.cu``).

A CUDA tensor launches the hand-written kernels, or raises; a CPU tensor runs
the plain PyTorch version (``ref.py``).  The tensors' device alone decides:
there is no mode switch and no fallback.  One call on the card is three
kernels on the current stream: per-(chunk, head) state contributions, the
scan over chunks, and per-(chunk, head) outputs; it counts as one launch.
"""

from __future__ import annotations

from typing import Tuple

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.gla_chunk.ref import gla_chunked_ref

KEY_DIMS = (16, 64)   # dk the kernel is instantiated for
VALUE_DIMS = (64,)    # dv
CHUNK = 64            # steps per chunk (csrc/gla_chunk.cu kChunk)
MAX_GRID_Y = 65_535   # batch x heads ride in gridDim.y


def _check(q, k, v, g) -> None:
    if q.dim() != 4 or k.shape != q.shape or g.shape != q.shape:
        raise ValueError(f"expected q, k, g (B, H, T, dk) of one shape; got "
                         f"{tuple(q.shape)}, {tuple(k.shape)}, {tuple(g.shape)}")
    if v.dim() != 4 or v.shape[:3] != q.shape[:3]:
        raise ValueError(f"v {tuple(v.shape)} does not match q {tuple(q.shape)}")
    for what, t in (("k", k), ("v", v), ("g", g)):
        if t.dtype != q.dtype or t.device != q.device:
            raise ValueError(f"{what} is {t.dtype} on {t.device}, q {q.dtype} "
                             f"on {q.device}")
    _build.float_code(q, "q")
    for what, t in (("q", q), ("k", k), ("v", v), ("g", g)):
        if not t.is_contiguous():
            raise ValueError(f"{what} must be contiguous (B, H, T, d); call "
                             ".contiguous() on a transposed view")


def gla_chunked(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                g: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Gated linear attention over q, k, g (B, H, T, dk) and v (B, H, T, dv),
    contiguous, f32 or bf16; g is the per-step log-decay, clamped to [-8, 0].
    Returns (o (B, H, T, dv) in q's dtype, final state (B, H, dk, dv) f32).
    Any T: the kernel reads steps past T as zero q, k, v and zero decay.  On
    the card (dk, dv) must be (16, 64) or (64, 64).
    """
    _check(q, k, v, g)
    _build.count(gla_chunked, "calls")
    if q.device.type == "cpu":
        return gla_chunked_ref(q, k, v, g)
    if q.device.type != "cuda":
        raise ValueError(f"gla_chunked runs on cuda or cpu, not {q.device}")
    b, h, t, dk = q.shape
    dv = v.shape[-1]
    if dk not in KEY_DIMS or dv not in VALUE_DIMS:
        raise ValueError(f"(dk, dv) = ({dk}, {dv}): the kernel takes dk in "
                         f"{KEY_DIMS}, dv in {VALUE_DIMS}")
    if b * h > MAX_GRID_Y:
        raise ValueError(f"{b} x {h} (batch x heads) exceeds the grid")
    if any(x.data_ptr() % 16 for x in (q, k, v, g)):
        raise ValueError("q, k, v, g must be 16-byte aligned")
    lib = _build.load("gla_chunk")
    o = torch.empty_like(v)
    state = torch.empty((b, h, dk, dv), dtype=torch.float32, device=q.device)
    # scratch of the three passes: each chunk's state contribution (then the
    # state before it) and its decay
    chunks = -(-t // CHUNK)
    ds = torch.empty((b * h, chunks, dk, dv), dtype=torch.float32, device=q.device)
    decay = torch.empty((b * h, chunks, dk), dtype=torch.float32, device=q.device)
    with torch.cuda.device(q.device):
        rc = lib.gla_chunk_launch(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), g.data_ptr(),
            o.data_ptr(), state.data_ptr(), ds.data_ptr(), decay.data_ptr(),
            _build.float_code(q, "q"), b * h, t, dk, dv,
            torch.cuda.current_stream(q.device).cuda_stream)
    _build.check(lib, "gla_chunk", rc)
    _build.count(gla_chunked, "launches")
    return o, state


# ``calls`` counts every call on either device; ``launches`` counts calls
# that launched on the card, one per call for its three kernels (see
# kernels/block_agg/ops.py).
gla_chunked.calls = 0
gla_chunked.launches = 0
