"""Gated linear attention (RWKV6 "Finch" family) of the port.

Counterpart of the reference's ``models/linear_attn.py``: the recurrence

    S_t = diag(exp(g_t)) S_{t-1} + k_t v_t^T ,   o_t = S_t^T q_t

over chunks, through the gla_chunk wrapper (``kernels/gla_chunk``): the
hand-written kernel on the card, its plain chunked version on the CPU.  The
log-decay is clamped to [-8, 0], as the reference clamps it.  The recurrent
``gla_decode_step`` and a carried-in initial state are not ported yet
(ROADMAP queue 1 item 14).
"""

from __future__ import annotations

from typing import Tuple

import torch

from repro_torch.kernels.gla_chunk import gla_chunked as _gla_kernel


def gla_chunked(q, k, v, g) -> Tuple[torch.Tensor, torch.Tensor]:
    """q, k, g (B, H, T, dk); v (B, H, T, dv), in any layout.  Returns (o
    (B, H, T, dv) in q's dtype, final state (B, H, dk, dv) f32)."""
    return _gla_kernel(q.contiguous(), k.contiguous(), v.contiguous(),
                       g.contiguous())
