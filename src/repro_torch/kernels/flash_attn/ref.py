"""Plain PyTorch version of flash_attn (the CPU route and the kernel's
yardstick in tests and ``chip_smoke.py``)."""

from __future__ import annotations

from typing import Optional

import torch

NEG_INF = -1e30


def flash_attention_ref(q, k, v, *, causal: bool = True, window: int = 0,
                        scale: Optional[float] = None) -> torch.Tensor:
    """Dense f32 softmax attention: q (B, Hq, Sq, d), k/v (B, Hkv, Skv, d),
    q head h reading kv head ``h // (Hq // Hkv)``.  Masks ``col > row`` when
    causal and ``col <= row - window`` when ``window > 0`` (positions from
    0); masked scores are -1e30, as in the kernel.  Returns q's dtype."""
    hq, sq, d = q.shape[1], q.shape[2], q.shape[3]
    hkv, skv = k.shape[1], k.shape[2]
    scale = float(scale if scale is not None else 1.0 / (d ** 0.5))
    kv_head = torch.arange(hq, device=q.device) // (hq // hkv)
    kf = k.float().index_select(1, kv_head)
    vf = v.float().index_select(1, kv_head)
    s = torch.matmul(q.float(), kf.transpose(-1, -2)) * scale
    rows = torch.arange(sq, device=q.device)[:, None]
    cols = torch.arange(skv, device=q.device)[None, :]
    mask = torch.ones((sq, skv), dtype=torch.bool, device=q.device)
    if causal:
        mask = mask & (cols <= rows)
    if window:
        mask = mask & (cols > rows - window)
    s = s.masked_fill(~mask, NEG_INF)
    p = torch.exp(s - s.amax(dim=-1, keepdim=True))
    p = p / p.sum(dim=-1, keepdim=True)
    return torch.matmul(p, vf).to(q.dtype)
