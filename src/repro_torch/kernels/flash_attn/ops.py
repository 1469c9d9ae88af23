"""Wrapper of the flash_attn CUDA kernel (``csrc/flash_attn.cu``).

A CUDA tensor launches the hand-written kernel, or raises; a CPU tensor runs
the plain PyTorch version (``ref.py``).  The tensors' device alone decides:
there is no mode switch and no fallback.
"""

from __future__ import annotations

from typing import Optional

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.flash_attn.ref import flash_attention_ref

HEAD_DIMS = (64, 128)  # the widths the kernel is instantiated for
MAX_GRID_YZ = 65_535   # q heads ride in gridDim.y, the batch in gridDim.z


def _check(q, k, v, window: int, q_offset: int) -> None:
    if q.dim() != 4 or k.dim() != 4 or v.shape != k.shape:
        raise ValueError(f"expected q (B, Hq, Sq, d) and k, v (B, Hkv, Skv, d); "
                         f"got {tuple(q.shape)}, {tuple(k.shape)}, {tuple(v.shape)}")
    b, hq, sq, d = q.shape
    if k.shape[0] != b or k.shape[3] != d:
        raise ValueError(f"k, v {tuple(k.shape)} do not match q {tuple(q.shape)}")
    hkv = k.shape[1]
    if hkv < 1 or hq % hkv:
        raise ValueError(f"{hq} q heads are not a multiple of {hkv} kv heads")
    if sq < 1 or k.shape[2] < 1:
        raise ValueError("empty q or kv sequence")
    for what, t in (("k", k), ("v", v)):
        if t.dtype != q.dtype or t.device != q.device:
            raise ValueError(f"{what} is {t.dtype} on {t.device}, q {q.dtype} "
                             f"on {q.device}")
    _build.float_code(q, "q")
    for what, t in (("q", q), ("k", k), ("v", v)):
        if not t.is_contiguous():
            raise ValueError(f"{what} must be contiguous (B, H, S, d); call "
                             ".contiguous() on a transposed view")
    if window < 0:
        raise ValueError(f"window {window} < 0")
    if q_offset != 0:
        raise NotImplementedError(
            "q_offset != 0 (prefill resume) is not ported yet: ROADMAP queue 1 "
            "item 14 (prefill, decode_step)")


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True, window: int = 0, q_offset: int = 0,
                    scale: Optional[float] = None) -> torch.Tensor:
    """Attention of q (B, Hq, Sq, d) over k, v (B, Hkv, Skv, d), contiguous,
    f32 or bf16, Hq a multiple of Hkv (q head h reads kv head
    ``h // (Hq // Hkv)``, no repeated K/V).  Masks: keys past Skv never;
    ``col > row`` when causal; ``col <= row - window`` when ``window > 0``
    (the models' sliding window).  Scores, softmax and accumulation in f32;
    returns q's dtype and shape.  On the card d must be 64 or 128.
    """
    _check(q, k, v, window, q_offset)
    _build.count(flash_attention, "calls")
    if q.device.type == "cpu":
        return flash_attention_ref(q, k, v, causal=causal, window=window,
                                   scale=scale)
    if q.device.type != "cuda":
        raise ValueError(f"flash_attention runs on cuda or cpu, not {q.device}")
    b, hq, sq, d = q.shape
    hkv, skv = k.shape[1], k.shape[2]
    if d not in HEAD_DIMS:
        raise ValueError(f"head_dim {d}: the kernel takes {HEAD_DIMS}")
    if hq > MAX_GRID_YZ or b > MAX_GRID_YZ:
        raise ValueError(f"{b} x {hq} (batch x heads) exceeds the grid")
    if any(t.data_ptr() % 16 for t in (q, k, v)):
        raise ValueError("q, k, v must be 16-byte aligned")
    scale = float(scale if scale is not None else 1.0 / (d ** 0.5))
    lib = _build.load("flash_attn")
    o = torch.empty_like(q)
    with torch.cuda.device(q.device):
        rc = lib.flash_attn_launch(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
            _build.float_code(q, "q"), b, hq, hkv, sq, skv, d, scale,
            int(causal), int(window),
            torch.cuda.current_stream(q.device).cuda_stream)
    _build.check(lib, "flash_attn", rc)
    _build.count(flash_attention, "launches")
    return o


# ``calls`` counts every call on either device; ``launches`` counts CUDA
# kernel launches only (see kernels/block_agg/ops.py).
flash_attention.calls = 0
flash_attention.launches = 0
