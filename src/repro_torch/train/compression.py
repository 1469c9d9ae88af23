"""Error-feedback int8 gradient compression of the port: the reference's
``train/compression.py`` (1-bit-Adam / EF-SGD family).

The quantizer is per-tensor symmetric int8 with a max-abs scale; error
feedback carries each step's quantization residual into the next, so the
applied updates telescope to the true gradient sum.  On one card there is no
gradient reduction for it to shrink: the algebra is ported so that a run with
``--compress-grads`` computes what the reference's does.
"""

from __future__ import annotations

from typing import Dict, Tuple

import torch

INT8_MAX = 127.0

Tree = Dict[str, torch.Tensor]


def quantize(x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Symmetric per-tensor int8.  Returns (q, scale f32)."""
    xf = x.float()
    scale = torch.max(torch.abs(xf)) / INT8_MAX
    scale = torch.where(scale > 0, scale, torch.ones_like(scale))
    q = torch.clamp(torch.round(xf / scale), -INT8_MAX, INT8_MAX).to(torch.int8)
    return q, scale


def dequantize(q: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    return q.float() * scale


def compress_leaf(g: torch.Tensor, residual: torch.Tensor):
    """Error-feedback step: compress (g + residual), carry the error.
    Returns (g_hat in g's dtype, new residual f32, its squared norm)."""
    target = g.float() + residual
    q, scale = quantize(target)
    g_hat = dequantize(q, scale)
    new_residual = target - g_hat
    return g_hat.to(g.dtype), new_residual, torch.sum(new_residual ** 2)


def compress_tree(grads: Tree, residuals: Tree) -> Tuple[Tree, Tree, torch.Tensor]:
    """Returns (compressed grads, new residuals, total squared error)."""
    outs = {n: compress_leaf(g, residuals[n]) for n, g in grads.items()}
    err = torch.sum(torch.stack([o[2] for o in outs.values()]))
    return ({n: o[0] for n, o in outs.items()}, {n: o[1] for n, o in outs.items()}, err)
