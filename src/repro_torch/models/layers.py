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
from torch.distributed.tensor import DTensor, Partial, Replicate, Shard

from repro_torch.kernels.flash_attn import flash_attention

NEG_INF = -1e30


def like(t: torch.Tensor, ref: torch.Tensor) -> torch.Tensor:
    """``t`` (the same on every rank) as a replicated DTensor on ``ref``'s
    mesh when ``ref`` is a DTensor and ``t`` is not, else ``t`` itself: so
    that a sharded pass mixes no plain tensor into DTensor ops, forward or
    backward."""
    if not isinstance(ref, DTensor) or isinstance(t, DTensor):
        return t
    mesh = ref.device_mesh
    return DTensor.from_local(t, mesh, [Replicate()] * mesh.ndim, run_check=False)


def heads(x: torch.Tensor, *shape: int, dim: int = -1) -> torch.Tensor:
    """``x.view(*shape)``, splitting x's dim ``dim`` (the last by default)
    into two, (heads, head_dim) or (kv heads, group).  On a mesh, that dim
    sharded over more ranks than divide the outer of the two is first
    gathered over those mesh dims (a GQA model's few kv heads on a wide
    model axis)."""
    if isinstance(x, DTensor):
        at, mesh = dim % x.ndim, x.device_mesh
        split = [i for i, p in enumerate(x.placements) if p.is_shard(at)]
        ranks = 1
        for i in split:
            ranks *= mesh.size(i)
        if shape[at] % ranks:
            x = x.redistribute(mesh, [Replicate() if i in split else p
                                      for i, p in enumerate(x.placements)])
    return x.view(*shape)


def roll(x: torch.Tensor, shift: int, dim: int) -> torch.Tensor:
    """``torch.roll(x, shift, dims=dim)``.  On a mesh each rank rolls its
    own tensor, with ``dim`` first gathered where it is sharded: torch
    2.11's DTensor has no rule for roll."""
    if not isinstance(x, DTensor):
        return torch.roll(x, shift, dims=dim)
    mesh, at = x.device_mesh, dim % x.ndim
    pl = [Replicate() if p.is_shard(at) or p.is_partial() else p for p in x.placements]
    local = torch.roll(x.redistribute(mesh, pl).to_local(), shift, dims=at)
    return DTensor.from_local(local, mesh, pl, run_check=False, shape=x.shape,
                              stride=torch.empty(x.shape, device="meta").stride())


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
    ang = like(positions, x).float()[..., None] * like(freqs, x)   # (..., S, half)
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
    if isinstance(q, DTensor) and any(k.shape[1] % n for n in q.device_mesh.shape):
        # on a mesh whose axes do not divide the kv heads the kernel cannot
        # run on head shards (its sharding rule): give every q head its own
        # kv head, so the heads shard as the q heads do.  The repeat runs on
        # whole heads, and the closing no-op redistribute hands its
        # gradient back whole too (a head-sharded one cannot be folded into
        # fewer heads than ranks)
        b, hkv, skv, d = k.shape
        g = q.shape[1] // hkv

        def repeat(t):
            mesh = t.device_mesh
            whole = [Replicate() if p.is_shard(1) else p for p in t.placements]
            t = t.redistribute(mesh, whole)[:, :, None].expand(b, hkv, g, skv, d)
            t = t.reshape(b, hkv * g, skv, d)
            return t.redistribute(mesh, t.placements)
        k, v = repeat(k), repeat(v)
    return flash_attention(q.contiguous(), k.contiguous(), v.contiguous(),
                           causal=causal, window=window, q_offset=q_offset,
                           scale=scale)


def decode_attention(q, k_cache, v_cache, *, pos, window: int = 0,
                     scale: Optional[float] = None) -> torch.Tensor:
    """Single-token attention of q (B, Hq, d) against caches (B, Hkv, S, d)
    at per-sequence positions ``pos`` (B,): slot s is seen when ``s <= pos``
    (and ``s > pos - window`` when ``window > 0``).  The reference's numerics:
    scores and softmax in f32, the weights cast to the cache dtype before
    the second product, which accumulates in f32; returns q's dtype.  On a
    mesh (q a DTensor) the products run on each rank's own rows, heads and
    cache slots (:func:`_decode_attention_mesh`)."""
    if isinstance(q, DTensor):
        return _decode_attention_mesh(q, k_cache, v_cache, pos=pos,
                                      window=window, scale=scale)
    b, hq, d = q.shape
    hkv = k_cache.shape[1]
    scale = float(scale if scale is not None else 1.0 / (d ** 0.5))
    qg = heads(q.contiguous(), b, hkv, hq // hkv, d, dim=1).float()
    sc = torch.matmul(qg, k_cache.float().transpose(-1, -2)) * scale
    p = _decode_weights(sc, pos, window, v_cache.dtype)
    o = torch.matmul(p.float(), v_cache.float())
    return o.reshape(b, hq, d).to(q.dtype)


def _decode_attention_mesh(q, k_cache, v_cache, *, pos, window, scale):
    """:func:`decode_attention` of a DTensor q: every product on local
    tensors, so no DTensor op rule is asked for a view of sharded heads.

    The cache stays where it lives: on each mesh dim it keeps a shard of
    its batch, kv heads or slots when that dim divides them, and is
    gathered otherwise.  q is placed to match (batch with batch, q heads
    with their kv heads), so each rank's scores are those of its rows and
    heads over its slots.  Where the slots are sharded, the scores are
    gathered over those mesh dims, the masked softmax runs over every slot
    with global positions, and each rank multiplies its own slots' weights
    by its own values; those partial sums are then added over the same
    dims.  Returns o (B, Hq, d) in q's placements (a Partial one made
    whole)."""
    mesh = q.device_mesh
    b, hq, d = q.shape
    hkv, s = k_cache.shape[1], k_cache.shape[2]
    rep = hq // hkv
    scale = float(scale if scale is not None else 1.0 / (d ** 0.5))
    k_cache, v_cache = like(k_cache, q), like(v_cache, q)
    # the cache's dim each mesh dim shards (None: whole), where it divides
    size = {0: b, 1: hkv, 2: s}
    ranks = {0: 1, 1: 1, 2: 1}
    split = []
    for i, p in enumerate(k_cache.placements):
        at = p.dim if p.is_shard() and p.dim in size else None
        if at is not None and size[at] % (ranks[at] * mesh.size(i)) == 0:
            ranks[at] *= mesh.size(i)
            split.append(at)
        else:
            split.append(None)
    cache_pl = [Replicate() if a is None else Shard(a) for a in split]
    # q (B, Hq, d): batch as the cache's batch, q heads as their kv heads
    q_pl = [Shard(a) if a in (0, 1) else Replicate() for a in split]
    sc_pl = [Shard(3) if a == 2 else Shard(a) if a is not None else Replicate()
             for a in split]
    whole_pl = [Replicate() if a == 2 else p for a, p in zip(split, sc_pl)]
    ql = q.redistribute(mesh, q_pl).to_local()
    kl = k_cache.redistribute(mesh, cache_pl).to_local()
    vl = v_cache.redistribute(mesh, cache_pl).to_local()
    pos_pl = [Shard(0) if a == 0 else Replicate() for a in split]
    posl = like(pos, q).redistribute(mesh, pos_pl).to_local()
    if all(a != 2 for a in split):
        o = decode_attention(ql, kl, vl, pos=posl, window=window, scale=scale)
    else:
        # every slot's score, then each rank's own slots' weights
        bl, hkv_l = kl.shape[0], kl.shape[1]
        qg = ql.contiguous().view(bl, hkv_l, rep, d).float()
        sc = torch.matmul(qg, kl.float().transpose(-1, -2)) * scale
        sc = DTensor.from_local(sc, mesh, sc_pl, run_check=False)
        sc = sc.redistribute(mesh, whole_pl).to_local()
        pfull = _decode_weights(sc, posl, window, v_cache.dtype)
        pl = DTensor.from_local(pfull, mesh, whole_pl, run_check=False)
        pl = pl.redistribute(mesh, sc_pl).to_local()
        part = torch.matmul(pl.float(), vl.float())          # (bl, hkv_l, rep, d)
        out_pl = [Partial() if a == 2 else p for a, p in zip(split, sc_pl)]
        o = DTensor.from_local(part, mesh, out_pl, run_check=False)
        o = o.redistribute(mesh, whole_pl).to_local()
        o = o.reshape(bl, hkv_l * rep, d).to(q.dtype)
    o = DTensor.from_local(o, mesh, q_pl, run_check=False)
    back = [Replicate() if p.is_partial() else p for p in q.placements]
    return o.redistribute(mesh, back)


def _decode_weights(sc, pos, window, dtype):
    """The masked softmax of scores (B, Hkv, rep, S) over every slot, in
    the cache dtype ``dtype``."""
    s = sc.shape[-1]
    k_pos = torch.arange(s, device=sc.device)
    pos = pos.to(torch.int64)
    mask = k_pos[None, :] <= pos[:, None]                 # (B, S)
    if window:
        mask = mask & (k_pos[None, :] > (pos - window)[:, None])
    sc = torch.where(mask[:, None, None, :], sc, NEG_INF)
    return torch.softmax(sc, dim=-1).to(dtype)


def mlp_block(x, w1, w2, w3, kind: str = "swiglu"):
    """Gated MLP: swiglu (SiLU gate) or geglu (GELU gate, gemma)."""
    h = x @ w1
    g = x @ w3
    act = F.silu(h) if kind == "swiglu" else F.gelu(h, approximate="tanh")
    return (act * g) @ w2
