"""Plain PyTorch versions of flash_attn, forward and backward (the CPU route
and the kernels' yardstick in tests and ``chip_smoke.py``)."""

from __future__ import annotations

from typing import Optional, Tuple

import torch

NEG_INF = -1e30


def _visible(sq: int, skv: int, causal: bool, window: int, device) -> torch.Tensor:
    """(Sq, Skv) bool: key ``col`` is seen by query ``row``."""
    rows = torch.arange(sq, device=device)[:, None]
    cols = torch.arange(skv, device=device)[None, :]
    mask = torch.ones((sq, skv), dtype=torch.bool, device=device)
    if causal:
        mask = mask & (cols <= rows)
    if window:
        mask = mask & (cols > rows - window)
    return mask


def _wide(x: torch.Tensor) -> torch.Tensor:
    """x in f32, or f64 kept (the finite-difference checks)."""
    return x.to(torch.promote_types(x.dtype, torch.float32))


def _scale(d: int, scale: Optional[float]) -> float:
    return float(scale if scale is not None else 1.0 / (d ** 0.5))


def flash_attention_lse_ref(q, k, v, *, causal: bool = True, window: int = 0,
                            scale: Optional[float] = None) -> Tuple[torch.Tensor, torch.Tensor]:
    """:func:`flash_attention_ref` and each row's log-sum-exp of its scaled
    scores, (B, Hq, Sq) f32: ``o = sum_col exp(s - lse) v``."""
    hq, sq, d = q.shape[1], q.shape[2], q.shape[3]
    hkv, skv = k.shape[1], k.shape[2]
    scale = _scale(d, scale)
    kv_head = torch.arange(hq, device=q.device) // (hq // hkv)
    kf = _wide(k).index_select(1, kv_head)
    vf = _wide(v).index_select(1, kv_head)
    s = torch.matmul(_wide(q), kf.transpose(-1, -2)) * scale
    s = s.masked_fill(~_visible(sq, skv, causal, window, q.device), NEG_INF)
    m = s.amax(dim=-1, keepdim=True)
    p = torch.exp(s - m)
    den = p.sum(dim=-1, keepdim=True)
    p = p / den
    return torch.matmul(p, vf).to(q.dtype), (m + torch.log(den))[..., 0]


def flash_attention_ref(q, k, v, *, causal: bool = True, window: int = 0,
                        scale: Optional[float] = None) -> torch.Tensor:
    """Dense f32 softmax attention: q (B, Hq, Sq, d), k/v (B, Hkv, Skv, d),
    q head h reading kv head ``h // (Hq // Hkv)``.  Masks ``col > row`` when
    causal and ``col <= row - window`` when ``window > 0`` (positions from
    0); masked scores are -1e30, as in the kernel.  Returns q's dtype."""
    return flash_attention_lse_ref(q, k, v, causal=causal, window=window,
                                   scale=scale)[0]


def flash_attention_bwd_ref(q, k, v, o, lse, do, *, causal: bool = True,
                            window: int = 0, scale: Optional[float] = None):
    """The gradients (dq, dk, dv) of attention, in the inputs' dtypes, from
    the forward's output ``o`` and row log-sum-exp ``lse`` (B, Hq, Sq) f32
    and the output's gradient ``do``, by the kernel's math in f32 (f64
    inputs stay f64): ``P = exp(scale q k^T - lse)`` (0 where masked), ``delta = rowsum(do o)``,
    ``dv = P^T do``, ``dS = P (do v^T - delta)``, ``dq = scale dS k``,
    ``dk = scale dS^T q``.  A kv head's dk and dv sum those of its
    ``Hq // Hkv`` q heads, in head order."""
    b, hq, sq, d = q.shape
    hkv, skv = k.shape[1], k.shape[2]
    rep = hq // hkv
    scale = _scale(d, scale)
    kv_head = torch.arange(hq, device=q.device) // rep
    qf, of, dof = _wide(q), _wide(o), _wide(do)
    kf = _wide(k).index_select(1, kv_head)
    vf = _wide(v).index_select(1, kv_head)
    s = torch.matmul(qf, kf.transpose(-1, -2)) * scale
    p = torch.exp(s - _wide(lse)[..., None])
    p = p.masked_fill(~_visible(sq, skv, causal, window, q.device), 0.0)
    delta = (dof * of).sum(dim=-1, keepdim=True)
    dv_h = torch.matmul(p.transpose(-1, -2), dof)
    ds = p * (torch.matmul(dof, vf.transpose(-1, -2)) - delta)
    dq = torch.matmul(ds, kf) * scale
    dk_h = torch.matmul(ds.transpose(-1, -2), qf) * scale

    def per_kv_head(x):
        x = x.view(b, hkv, rep, skv, d)
        acc = x[:, :, 0]
        for r in range(1, rep):
            acc = acc + x[:, :, r]
        return acc

    return dq.to(q.dtype), per_kv_head(dk_h).to(k.dtype), per_kv_head(dv_h).to(v.dtype)


def attention_ref(q, k, v, *, scale: float, causal: bool, kv_len=None):
    """q (Sq, d), k / v (Skv, d): attention with every score materialized,
    one head, in f32; keys at or past ``kv_len`` are masked.  The
    reference's dense oracle (``kernels/flash_attn/ref.py``), independent of
    :func:`flash_attention_ref`'s batched GQA form; returns q's dtype."""
    qf, kf, vf = (x.to(torch.float32) for x in (q, k, v))
    s = (qf @ kf.T) * scale
    sq, skv = q.shape[0], k.shape[0]
    cols = torch.arange(skv, device=q.device)[None, :]
    mask = torch.ones((sq, skv), dtype=torch.bool, device=q.device)
    if kv_len is not None:
        mask = mask & (cols < kv_len)
    if causal:
        mask = mask & (cols <= torch.arange(sq, device=q.device)[:, None])
    s = torch.where(mask, s, NEG_INF)
    p = torch.exp(s - s.amax(dim=1, keepdim=True))
    p = p / p.sum(dim=1, keepdim=True)
    return (p @ vf).to(q.dtype)
