"""Plain PyTorch version of gla_chunk (the CPU route and the kernel's
yardstick in tests and ``chip_smoke.py``): the vectorised chunked ``dif``
form of the reference's ``models/linear_attn.py`` ``gla_chunked_xla``."""

from __future__ import annotations

import torch
import torch.nn.functional as F

G_CLAMP = -8.0  # per-step log-decay floor: keeps within-chunk ratios bounded
CHUNK = 64      # the kernel's chunk


def gla_chunked_ref(q, k, v, g, *, chunk: int = CHUNK):
    """q, k, g (B, H, T, dk); v (B, H, T, dv).  Returns (o (B, H, T, dv) in
    q's dtype, final state (B, H, dk, dv) f32) of the recurrence
    ``S_t = diag(e^{g_t}) S_{t-1} + k_t v_t^T``, ``o_t = S_t^T q_t``, with g
    clamped to [-8, 0] and T padded with zero steps.  Within a chunk every
    exponent is <= 0: the (C, C, dk) relative decays are masked before exp.
    """
    b, h, t, dk = q.shape
    dv = v.shape[-1]
    qf, kf, vf = (x.float() for x in (q, k, v))
    gf = g.float().clamp(G_CLAMP, 0.0)
    pad = (-t) % chunk
    if pad:
        qf, kf, vf, gf = (F.pad(x, (0, 0, 0, pad)) for x in (qf, kf, vf, gf))
    tri = torch.ones((chunk, chunk), dtype=torch.bool, device=q.device).tril()
    state = torch.zeros((b, h, dk, dv), dtype=torch.float32, device=q.device)
    outs = []
    for c0 in range(0, t + pad, chunk):
        qi, ki, vi, gi = (x[:, :, c0:c0 + chunk] for x in (qf, kf, vf, gf))
        L = gi.cumsum(dim=2)                                   # decreasing
        L_last = L[:, :, -1:, :]
        inter = torch.matmul(qi * torch.exp(L), state)
        dif = L[:, :, :, None, :] - L[:, :, None, :, :]        # (b,h,C,C,dk)
        dif = dif.masked_fill(~tri[:, :, None], float("-inf"))  # before exp
        attn = (qi[:, :, :, None, :] * ki[:, :, None, :, :]
                * torch.exp(dif)).sum(dim=-1)
        intra = torch.matmul(attn, vi)
        k_carry = ki * torch.exp(L_last - L)
        state = (state * torch.exp(L_last).transpose(-1, -2)
                 + torch.matmul(k_carry.transpose(-1, -2), vi))
        outs.append(inter + intra)
    o = torch.cat(outs, dim=2)[:, :, :t]
    return o.to(q.dtype), state
