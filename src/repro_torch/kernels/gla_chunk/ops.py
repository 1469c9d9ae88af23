"""Wrapper of the gla_chunk CUDA kernels: the forward (``csrc/gla_chunk.cu``)
and the backward (``csrc/gla_chunk_bwd.cu``), joined by an autograd
Function.

A CUDA tensor launches the hand-written kernels, or raises; a CPU tensor runs
the plain PyTorch versions (``ref.py``).  The tensors' device alone decides:
there is no mode switch and no fallback.  One forward call on the card is
three kernels on the current stream: per-(chunk, head) state contributions,
the scan over chunks, and per-(chunk, head) outputs; it counts as one
launch.  The scan leaves the state before each chunk in its scratch, which
the Function keeps for the backward (three kernels, one count).
"""

from __future__ import annotations

from typing import Tuple

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.gla_chunk.ref import gla_chunked_bwd_ref, gla_chunked_fwd_ref

# the (dk, dv) pairs each dtype's kernels, forward and backward, are built
# for: hymba's (16, 64), rwkv6's (64, 64), and the reduced configs' (8, 16)
KEY_VALUE_DIMS = {torch.bfloat16: ((16, 64), (64, 64)),
                  torch.float32: ((16, 64), (64, 64), (8, 16))}
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


def _check_widths(q, dk: int, dv: int) -> None:
    if (dk, dv) not in KEY_VALUE_DIMS[q.dtype]:
        raise ValueError(f"(dk, dv) = ({dk}, {dv}): the {str(q.dtype)[6:]} kernels "
                         f"take {KEY_VALUE_DIMS[q.dtype]}")


def _forward(q, k, v, g):
    """(o, final state, the state before each chunk (B, H, chunks, dk, dv)
    f32): the forward kernels on the card (the states are the scan pass's
    scratch), the plain version on the CPU."""
    if q.device.type == "cpu":
        return gla_chunked_fwd_ref(q, k, v, g)
    b, h, t, dk = q.shape
    dv = v.shape[-1]
    _check_widths(q, dk, dv)
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
    return o, state, ds.view(b, h, chunks, dk, dv)


def backward_checks(q, k, v, g, states, state, do, dstate) -> None:
    """What the backward kernels take, checked on the host (any device):
    the forward's shapes, do like v, the chunk-start states (B, H, chunks,
    dk, dv), the final state and dstate (B, H, dk, dv) f32, all contiguous
    and 16-byte aligned (the kernels' float4 and 16-byte loads)."""
    b, h, t, dk = q.shape
    dv = v.shape[-1]
    _check_widths(q, dk, dv)
    if b * h > MAX_GRID_Y:
        raise ValueError(f"{b} x {h} (batch x heads) exceeds the grid")
    if do.dtype != q.dtype or do.shape != v.shape:
        raise ValueError(f"the output's gradient is {tuple(do.shape)} {do.dtype}, v "
                         f"{tuple(v.shape)} {q.dtype}")
    chunks = -(-t // CHUNK)
    wants = [("states", states, (b, h, chunks, dk, dv)), ("state", state, (b, h, dk, dv))]
    if dstate is not None:
        wants.append(("dstate", dstate, (b, h, dk, dv)))
    for what, x, shape in wants:
        if tuple(x.shape) != shape or x.dtype != torch.float32:
            raise ValueError(f"{what} is {tuple(x.shape)} {x.dtype}, expected {shape} float32")
    for what, x in (("q", q), ("k", k), ("v", v), ("g", g), ("do", do), *[w[:2] for w in wants]):
        if not x.is_contiguous():
            raise ValueError(f"{what} must be contiguous")
        if x.data_ptr() % 16:
            raise ValueError(f"{what} must be 16-byte aligned")


def _backward(q, k, v, g, states, state, do, dstate):
    """(dq, dk, dv, dg): on the card the backward kernels, the chunks'
    state-gradient contributions, the reverse scan from ``dstate`` (None:
    zero), then every gradient of each chunk; on the CPU the plain
    version."""
    if q.device.type == "cpu":
        return gla_chunked_bwd_ref(q, k, v, g, states, do, dstate)
    if dstate is not None:
        dstate = dstate.float().contiguous()
    backward_checks(q, k, v, g, states, state, do, dstate)
    b, h, t, dk = q.shape
    dv = v.shape[-1]
    chunks = states.shape[2]
    lib = _build.load("gla_chunk_bwd")
    dq, dk_, dv_, dg = (torch.empty_like(x) for x in (q, k, v, g))
    # scratch: each chunk's contribution, then the gradient of the state
    # after it; its decay
    dh = torch.empty((b * h, chunks, dk, dv), dtype=torch.float32, device=q.device)
    decay = torch.empty((b * h, chunks, dk), dtype=torch.float32, device=q.device)
    with torch.cuda.device(q.device):
        rc = lib.gla_chunk_bwd_launch(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), g.data_ptr(),
            states.data_ptr(), state.data_ptr(), do.data_ptr(),
            dstate.data_ptr() if dstate is not None else None,
            dq.data_ptr(), dk_.data_ptr(), dv_.data_ptr(), dg.data_ptr(),
            dh.data_ptr(), decay.data_ptr(),
            _build.float_code(q, "q"), b * h, t, dk, dv,
            torch.cuda.current_stream(q.device).cuda_stream)
    _build.check(lib, "gla_chunk_bwd", rc)
    _build.count(gla_chunked, "bwd_launches")
    return dq, dk_, dv_, dg


class GlaChunkedFn(torch.autograd.Function):
    """Chunked GLA whose forward keeps the state before each chunk (the
    forward scan's scratch on the card) and whose backward reads it: the
    kernels on the card, the plain versions on the CPU.  The final state's
    gradient may be None (training ignores the state)."""

    @staticmethod
    def forward(ctx, q, k, v, g):
        ctx.set_materialize_grads(False)
        o, state, states = _forward(q, k, v, g)
        ctx.save_for_backward(q, k, v, g, states, state)
        return o, state

    @staticmethod
    @torch.autograd.function.once_differentiable
    def backward(ctx, do, dstate):
        q, k, v, g, states, state = ctx.saved_tensors
        do = torch.zeros_like(v) if do is None else do.contiguous()
        return _backward(q, k, v, g, states, state, do, dstate)


def gla_chunked(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                g: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Gated linear attention over q, k, g (B, H, T, dk) and v (B, H, T, dv),
    contiguous, f32 or bf16; g is the per-step log-decay, clamped to [-8, 0].
    Returns (o (B, H, T, dv) in q's dtype, final state (B, H, dk, dv) f32).
    Any T: the kernel reads steps past T as zero q, k, v and zero decay.  On
    the card (dk, dv) must be in ``KEY_VALUE_DIMS[dtype]``: (16, 64) or (64,
    64), and (8, 16) in f32; another raises.  Differentiable: the
    gradients come from the backward kernels (their plain versions on the
    CPU), in the inputs' dtypes; g's follows the reference's ``jnp.clip``,
    half a gradient on either bound.
    """
    _check(q, k, v, g)
    _build.count(gla_chunked, "calls")
    if q.device.type not in ("cpu", "cuda"):
        raise ValueError(f"gla_chunked runs on cuda or cpu, not {q.device}")
    return GlaChunkedFn.apply(q, k, v, g)


# ``calls`` counts every call on either device; ``launches`` counts forward
# calls that launched on the card, one per call for its three kernels, and
# ``bwd_launches`` backward ones, one per call for its three (see
# kernels/block_agg/ops.py).
gla_chunked.calls = 0
gla_chunked.launches = 0
gla_chunked.bwd_launches = 0
