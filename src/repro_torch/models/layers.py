"""Core layers of the port: RMSNorm, RoPE, attention and the gated MLP.

Counterparts of the reference's ``models/layers.py``.  Its ``mea_attention``
is the pure-XLA equivalent of the Pallas flash kernel; here attention goes
through the flash wrapper itself (``kernels/flash_attn``): the hand-written
kernel on the card, its plain version on the CPU.  GQA is by index, with no
repeated K/V.  ``decode_attention`` (one new token per sequence against a
cache) has no Pallas original: it is plain torch ops and ``torch.matmul``,
as the reference's is XLA einsums.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F

from repro_torch.kernels.flash_attn import flash_attention

NEG_INF = -1e30


def rms_norm(x: torch.Tensor, weight: torch.Tensor, eps: float = 1e-5) -> torch.Tensor:
    """Computed in f32 and scaled by ``(1 + weight)``; returns x's dtype."""
    xf = x.float()
    inv = torch.rsqrt(torch.mean(xf * xf, dim=-1, keepdim=True) + eps)
    return ((xf * inv) * (1.0 + weight.float())).to(x.dtype)


def rope(x: torch.Tensor, positions: torch.Tensor, theta: float = 1e4) -> torch.Tensor:
    """Half-split rotation (not interleaved) of x (..., S, d), d even, at
    ``positions`` (..., S) or (S,); returns x's dtype."""
    d = x.shape[-1]
    half = d // 2
    freqs = 1.0 / (theta ** (torch.arange(0, half, dtype=torch.float32,
                                          device=x.device) / half))
    ang = positions.float()[..., None] * freqs            # (..., S, half)
    cos, sin = torch.cos(ang), torch.sin(ang)
    x1, x2 = x[..., :half], x[..., half:]
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


def mea_attention(q, k, v, *, causal: bool = True, window: int = 0,
                  q_offset: int = 0, scale: Optional[float] = None) -> torch.Tensor:
    """Attention of q (B, Hq, Sq, d) over k, v (B, Hkv, Skv, d), Hq a multiple
    of Hkv; ``window > 0`` keeps the last ``window`` key positions (and
    self).  Takes the reference's transposed views as they come and hands the
    flash wrapper contiguous (B, H, S, d) tensors.  ``q_offset`` must be 0:
    no path of the reference passes another (``forward`` and ``prefill``
    start at position 0)."""
    return flash_attention(q.contiguous(), k.contiguous(), v.contiguous(),
                           causal=causal, window=window, q_offset=q_offset,
                           scale=scale)


def decode_attention(q, k_cache, v_cache, *, pos, window: int = 0,
                     scale: Optional[float] = None) -> torch.Tensor:
    """Single-token attention of q (B, Hq, d) against caches (B, Hkv, S, d)
    at per-sequence positions ``pos`` (B,): slot s is seen when ``s <= pos``
    (and ``s > pos - window`` when ``window > 0``).  The reference's numerics:
    scores and softmax in f32, the weights cast to the cache dtype before
    the second product, which accumulates in f32; returns q's dtype."""
    b, hq, d = q.shape
    hkv, s = k_cache.shape[1], k_cache.shape[2]
    scale = float(scale if scale is not None else 1.0 / (d ** 0.5))
    qg = q.reshape(b, hkv, hq // hkv, d).float()
    sc = torch.matmul(qg, k_cache.float().transpose(-1, -2)) * scale
    k_pos = torch.arange(s, device=q.device)
    pos = pos.to(torch.int64)
    mask = k_pos[None, :] <= pos[:, None]                 # (B, S)
    if window:
        mask = mask & (k_pos[None, :] > (pos - window)[:, None])
    sc = torch.where(mask[:, None, None, :], sc, NEG_INF)
    p = torch.softmax(sc, dim=-1).to(v_cache.dtype)
    o = torch.matmul(p.float(), v_cache.float())
    return o.reshape(b, hq, d).to(q.dtype)


def mlp_block(x, w1, w2, w3, kind: str = "swiglu"):
    """Gated MLP: swiglu (SiLU gate) or geglu (GELU gate, gemma)."""
    h = x @ w1
    g = x @ w3
    act = F.silu(h) if kind == "swiglu" else F.gelu(h, approximate="tanh")
    return (act * g) @ w2
