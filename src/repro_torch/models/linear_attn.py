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

from repro_torch.kernels.gla_chunk import gla_chunked as _gla_kernel
from repro_torch.kernels.gla_chunk.ref import G_CLAMP


def gla_chunked(q, k, v, g) -> Tuple[torch.Tensor, torch.Tensor]:
    """q, k, g (B, H, T, dk); v (B, H, T, dv), in any layout.  Returns (o
    (B, H, T, dv) in q's dtype, final state (B, H, dk, dv) f32)."""
    return _gla_kernel(q.contiguous(), k.contiguous(), v.contiguous(),
                       g.contiguous())


def gla_decode_step(q, k, v, g, state) -> Tuple[torch.Tensor, torch.Tensor]:
    """One recurrent step.  q, k, g (B, H, dk); v (B, H, dv); state (B, H,
    dk, dv) f32.  Returns (o (B, H, dv) in q's dtype, the new f32 state)."""
    g = g.float().clamp(G_CLAMP, 0.0)
    state = state * torch.exp(g)[..., None] + k.float()[..., None] * v.float()[..., None, :]
    o = torch.einsum("bhkv,bhk->bhv", state, q.float())
    return o.to(q.dtype), state
