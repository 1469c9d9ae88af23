"""Gated linear attention (RWKV6 "Finch" family) of the port.

Counterpart of the reference's ``models/linear_attn.py``: the recurrence

    S_t = diag(exp(g_t)) S_{t-1} + k_t v_t^T ,   o_t = S_t^T q_t

over chunks, through the gla_chunk wrapper (``kernels/gla_chunk``): the
hand-written kernel on the card, its plain chunked version on the CPU.  The
log-decay is clamped to [-8, 0], as the reference clamps it.  Decoding
carries the (dk, dv) state one token at a time (``gla_decode_step``, plain
torch ops: the reference's is XLA, with no Pallas original); ``prefill``
seeds that state with the chunked pass's final state.
"""

from __future__ import annotations

from typing import Tuple

import torch
from torch.distributed.tensor import DTensor, Replicate

from repro_torch.kernels.gla_chunk import gla_chunked as _gla_kernel
from repro_torch.kernels.gla_chunk.ref import G_CLAMP
from repro_torch.models.layers import like


def gla_chunked(q, k, v, g) -> Tuple[torch.Tensor, torch.Tensor]:
    """q, k, g (B, H, T, dk); v (B, H, T, dv), in any layout.  Returns (o
    (B, H, T, dv) in q's dtype, final state (B, H, dk, dv) f32)."""
    return _gla_kernel(q.contiguous(), k.contiguous(), v.contiguous(),
                       g.contiguous())


def gla_decode_step(q, k, v, g, state) -> Tuple[torch.Tensor, torch.Tensor]:
    """One recurrent step.  q, k, g (B, H, dk); v (B, H, dv); state (B, H,
    dk, dv) f32.  Returns (o (B, H, dv) in q's dtype, the new f32 state).
    On a mesh each rank steps its own rows and heads
    (:func:`_gla_decode_step_mesh`)."""
    if isinstance(state, DTensor):
        return _gla_decode_step_mesh(q, k, v, g, state)
    g = g.float().clamp(G_CLAMP, 0.0)
    state = state * torch.exp(g)[..., None] + k.float()[..., None] * v.float()[..., None, :]
    o = torch.einsum("bhkv,bhk->bhv", state, q.float())
    return o.to(q.dtype), state


def _gla_decode_step_mesh(q, k, v, g, state):
    """:func:`gla_decode_step` of a DTensor state: every input placed as
    the state shards its batch and heads (its other dims whole), the step
    run on each rank's local tensors, since torch 2.11's DTensor cannot
    flatten the sharded heads inside the einsum; returns DTensors in those
    placements."""
    mesh = state.device_mesh
    pl = [p if p.is_shard() and p.dim in (0, 1) else Replicate() for p in state.placements]
    local = [like(t, state).redistribute(mesh, pl).to_local() for t in (q, k, v, g, state)]
    o, new = gla_decode_step(*local)

    def whole(t, shape):
        return DTensor.from_local(t, mesh, pl, run_check=False, shape=shape,
                                  stride=torch.empty(shape, device="meta").stride())
    return whole(o, (*q.shape[:2], v.shape[-1])), whole(new, state.shape)
