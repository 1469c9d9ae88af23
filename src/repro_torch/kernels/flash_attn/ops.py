"""Wrapper of the flash_attn CUDA kernels: the forward (``csrc/flash_attn.cu``)
and the backward (``csrc/flash_attn_bwd.cu``), two custom operators joined
by autograd.

A CUDA tensor launches the hand-written kernels, or raises; a CPU tensor runs
the plain PyTorch versions (``ref.py``).  The tensors' device alone decides:
there is no mode switch and no fallback.  The forward writes each row's
log-sum-exp only when a gradient will be asked for, so an inference call
launches exactly what it did before the backward existed.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Optional, Tuple

import numpy as np
import torch
from torch.distributed.tensor import Replicate, Shard
from torch.distributed.tensor.experimental import register_sharding
from torch.utils.flop_counter import register_flop_formula

from repro_torch.kernels import _build
from repro_torch.kernels.flash_attn.ref import (flash_attention_bwd_ref,
                                                flash_attention_lse_ref)

# the head dims each dtype's kernels, forward and backward, are built for:
# bf16 on the tensor cores, f32 on the scalar kernels (16: the reduced
# configs')
HEAD_DIMS = {torch.bfloat16: (64, 128, 256), torch.float32: (16, 64, 128)}
MAX_GRID_YZ = 65_535   # q heads ride in gridDim.y, the batch in gridDim.z
BWD_TILE = 64          # rows of the backward's streamed tiles (csrc/flash_attn_bwd.cu)
# the rows of one CTA of the backward's two launches, (q rows of a dQ CTA,
# kv rows of a dK/dV CTA), by dtype and head dim: the source of
# ``backward_grids``.  The library reports its own (BwdShape in
# csrc/flash_attn_bwd.cu, through ``flash_attn_bwd_tile_rows``) and
# ``check_tile_rows`` holds the two equal when ``_build`` loads it.  bf16:
# dQ CTAs of two warpgroups (128 rows), one (64) at d 256; dK/dV CTAs of one
# warpgroup at d 64, two at d 128, two over the same 64 rows at d 256; f32:
# the scalar kernels' 64-row tiles.
BWD_TILE_ROWS = {torch.bfloat16: {64: (128, 64), 128: (128, 128), 256: (64, 64)},
                 torch.float32: {16: (64, 64), 64: (64, 64), 128: (64, 64)}}


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
            "q_offset != 0 is not supported: no path of the reference passes "
            "a non-zero offset (prefill and forward pass 0; decode_step "
            "attends through decode_attention)")


def _launch_checks(q: torch.Tensor) -> None:
    b, hq, _, d = q.shape
    if d not in HEAD_DIMS[q.dtype]:
        raise ValueError(f"head_dim {d}: the {str(q.dtype)[6:]} kernels take "
                         f"{HEAD_DIMS[q.dtype]}")
    if hq > MAX_GRID_YZ or b > MAX_GRID_YZ:
        raise ValueError(f"{b} x {hq} (batch x heads) exceeds the grid")


def _forward(q, k, v, causal: bool, window: int, scale: float, with_lse: bool):
    """(o, lse or None; lse (B, Hq, Sq) f32): the forward kernel on the
    card, the plain version (which always gives lse) on the CPU."""
    if q.device.type == "cpu":
        return flash_attention_lse_ref(q, k, v, causal=causal, window=window, scale=scale)
    _launch_checks(q)
    if any(t.data_ptr() % 16 for t in (q, k, v)):
        raise ValueError("q, k, v must be 16-byte aligned")
    b, hq, sq, d = q.shape
    hkv, skv = k.shape[1], k.shape[2]
    lib = _build.load("flash_attn")
    o = torch.empty_like(q)
    lse = (torch.empty((b, hq, sq), dtype=torch.float32, device=q.device)
           if with_lse else None)
    with torch.cuda.device(q.device):
        rc = lib.flash_attn_launch(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
            lse.data_ptr() if with_lse else None,
            _build.float_code(q, "q"), b, hq, hkv, sq, skv, d, scale,
            int(causal), int(window),
            torch.cuda.current_stream(q.device).cuda_stream)
    _build.check(lib, "flash_attn", rc)
    _build.count(flash_attention, "launches")
    return o, lse


def backward_grids(q, k):
    """The (x, y) CTA grids of the backward's two launches on the card, dQ
    then dK/dV, with the batch folded into x (the launch floor's shape),
    from ``BWD_TILE_ROWS``."""
    b, hq, sq, d = q.shape
    hkv, skv = k.shape[1], k.shape[2]
    q_rows, kv_rows = BWD_TILE_ROWS[q.dtype][d]
    return [(-(-sq // q_rows) * b, hq), (-(-skv // kv_rows) * b, hkv)]


def check_tile_rows(lib) -> None:
    """Raise unless the backward library's CTA rows, as its
    ``flash_attn_bwd_tile_rows`` reports them, are ``BWD_TILE_ROWS``'s for
    every dtype and head dim (``_build.load`` calls this when it loads the
    library, so the host's grids and the launches cannot drift apart)."""
    for dtype, by_dim in BWD_TILE_ROWS.items():
        for d, want in by_dim.items():
            q_rows, kv_rows = ctypes.c_int(-1), ctypes.c_int(-1)
            rc = lib.flash_attn_bwd_tile_rows(_build.FLOAT_CODES[dtype], d,
                                              ctypes.byref(q_rows), ctypes.byref(kv_rows))
            got = (q_rows.value, kv_rows.value)
            if rc != 0 or got != want:
                raise RuntimeError(
                    f"flash_attn_bwd: the library's {str(dtype)[6:]} d {d} CTAs hold (q, kv) "
                    f"rows {got} (code {rc}), BWD_TILE_ROWS says {want}")


def stats_floats(q) -> int:
    """Floats of the backward's stats scratch for q (B, Hq, Sq, d): each
    row's lse log2 e and delta, rows padded to a multiple of the 64-row
    tile (``csrc/flash_attn_bwd.cu``; the f32 kernels keep delta there)."""
    b, hq, sq, _ = q.shape
    return 2 * b * hq * (-(-sq // BWD_TILE) * BWD_TILE)


def backward_checks(q, k, v, o, lse, do, *, addresses: bool = True) -> None:
    """What the backward kernels take, checked on the host (any device):
    the forward's checks, o and do like q and contiguous, lse (B, Hq, Sq)
    f32 contiguous, every base 16-byte aligned (the TMA loads and the
    vector stores; ``addresses`` False skips that, for fake tensors), the
    stats scratch's rows within int32."""
    _launch_checks(q)
    if do.dtype != q.dtype:
        raise ValueError(f"the output's gradient is {do.dtype}, q {q.dtype}")
    for what, t in (("o", o), ("do", do)):
        if t.shape != q.shape or t.dtype != q.dtype:
            raise ValueError(f"{what} is {tuple(t.shape)} {t.dtype}, q {tuple(q.shape)} "
                             f"{q.dtype}")
    if lse.shape != q.shape[:3] or lse.dtype != torch.float32:
        raise ValueError(f"lse is {tuple(lse.shape)} {lse.dtype}, expected "
                         f"{tuple(q.shape[:3])} float32")
    for what, t in (("q", q), ("k", k), ("v", v), ("o", o), ("lse", lse), ("do", do)):
        if not t.is_contiguous():
            raise ValueError(f"{what} must be contiguous")
        if addresses and t.data_ptr() % 16:
            raise ValueError(f"{what} must be 16-byte aligned")
    if stats_floats(q) >= 2 ** 31:
        raise ValueError(f"{tuple(q.shape)}: 2 B Hq Sq (padded to {BWD_TILE}) rows exceed "
                         "int32")


def _backward(q, k, v, o, lse, do, causal: bool, window: int, scale: float):
    """(dq, dk, dv): on the card the backward kernels, dQ (with delta =
    rowsum(do o) in its prologue), then dK and dV, two launches on the
    current stream; on the CPU the plain version."""
    if q.device.type == "cpu":
        return flash_attention_bwd_ref(q, k, v, o, lse, do, causal=causal, window=window,
                                       scale=scale)
    backward_checks(q, k, v, o, lse, do)
    b, hq, sq, d = q.shape
    hkv, skv = k.shape[1], k.shape[2]
    lib = _build.load("flash_attn_bwd")
    dq, dk, dv = torch.empty_like(q), torch.empty_like(k), torch.empty_like(v)
    stats = torch.empty(stats_floats(q), dtype=torch.float32, device=q.device)
    with torch.cuda.device(q.device):
        rc = lib.flash_attn_bwd_launch(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(), lse.data_ptr(),
            do.data_ptr(), dq.data_ptr(), dk.data_ptr(), dv.data_ptr(),
            stats.data_ptr(), _build.float_code(q, "q"), b, hq, hkv, sq, skv, d,
            scale, int(causal), int(window),
            torch.cuda.current_stream(q.device).cuda_stream)
    _build.check(lib, "flash_attn_bwd", rc)
    _build.count(flash_attention, "bwd_launches")
    return dq, dk, dv


# The forward and the backward are custom operators (``repro_torch::``), so
# that a DTensor and a fake tensor can call them: autograd joins the two
# through ``register_autograd``; ``register_fake`` gives shapes and dtypes
# only (a trace under ``FakeTensorMode`` launches nothing); the FLOP formulas
# count the pairs the masks keep; the sharding rules run the kernel on each
# rank's shard of the batch or of the heads.  On a real tensor each op calls
# ``_forward`` / ``_backward``, looked up when it runs.

@torch.library.custom_op("repro_torch::flash_attention_fwd", mutates_args=())
def flash_attention_fwd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, causal: bool,
                        window: int, scale: float,
                        with_lse: bool) -> Tuple[torch.Tensor, torch.Tensor]:
    """(o, lse): lse (B, Hq, Sq) f32 when ``with_lse``, else (B, Hq, 0)."""
    o, lse = _forward(q, k, v, causal, window, scale, with_lse)
    if not with_lse:
        lse = q.new_empty(q.shape[:2] + (0,), dtype=torch.float32)
    return o, lse


@flash_attention_fwd.register_fake
def _(q, k, v, causal, window, scale, with_lse):
    if q.device.type == "cuda":
        _launch_checks(q)
    sq = q.shape[2] if with_lse else 0
    return torch.empty_like(q), q.new_empty(q.shape[:2] + (sq,), dtype=torch.float32)


@torch.library.custom_op("repro_torch::flash_attention_bwd", mutates_args=())
def flash_attention_bwd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, o: torch.Tensor,
                        lse: torch.Tensor, do: torch.Tensor, causal: bool, window: int,
                        scale: float) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(dq, dk, dv) of the forward's o against its gradient do."""
    return _backward(q, k, v, o, lse, do, causal, window, scale)


@flash_attention_bwd.register_fake
def _(q, k, v, o, lse, do, causal, window, scale):
    if q.device.type == "cuda":
        backward_checks(q, k, v, o, lse, do, addresses=False)   # a fake tensor has none
    return torch.empty_like(q), torch.empty_like(k), torch.empty_like(v)


def _setup_context(ctx, inputs, output):
    q, k, v, causal, window, scale, with_lse = inputs
    if with_lse:
        ctx.save_for_backward(q, k, v, output[0], output[1])
    ctx.attrs = (causal, window, scale)


def _backward_rule(ctx, do, _dlse):
    q, k, v, o, lse = ctx.saved_tensors
    dq, dk, dv = flash_attention_bwd(q, k, v, o, lse, do.contiguous(), *ctx.attrs)
    return dq, dk, dv, None, None, None, None


flash_attention_fwd.register_autograd(_backward_rule, setup_context=_setup_context)


@functools.lru_cache(maxsize=256)
def attention_pairs(sq: int, skv: int, causal: bool, window: int) -> int:
    """(query, key) pairs the masks keep: the work attention needs."""
    r = np.arange(sq)
    hi = np.minimum(r, skv - 1) if causal else np.full(sq, skv - 1)
    lo = np.maximum(0, r - window + 1) if window else np.zeros(sq, np.int64)
    return int(np.maximum(hi - lo + 1, 0).sum())


@register_flop_formula(torch.ops.repro_torch.flash_attention_fwd)
def _(q_shape, k_shape, v_shape, causal, window, scale, with_lse, out_shape=None):
    """4 d per kept pair and q head: QK^T and PV."""
    b, hq, sq, d = q_shape
    return 4 * d * b * hq * attention_pairs(sq, k_shape[2], causal, window)


@register_flop_formula(torch.ops.repro_torch.flash_attention_bwd)
def _(q_shape, k_shape, v_shape, o_shape, lse_shape, do_shape, causal, window, scale,
      out_shape=None):
    """10 d per kept pair and q head: S recomputed, dO V^T, dV, dK, dQ."""
    b, hq, sq, d = q_shape
    return 10 * d * b * hq * attention_pairs(sq, k_shape[2], causal, window)


def _shardings(q, k, v, *rest, outputs: int):
    """Single-mesh-dim strategies (outputs, then inputs; None for a
    non-tensor): replicated, batch-sharded, or head-sharded when every mesh
    dim divides the kv heads (q head h reads kv head h // (Hq / Hkv), which
    holds on each shard only then)."""
    tensors = 3 + sum(hasattr(t, "mesh") for t in rest)
    others = len(rest) + 3 - tensors
    strategies = [([Replicate()] * outputs, [Replicate()] * tensors + [None] * others),
                  ([Shard(0)] * outputs, [Shard(0)] * tensors + [None] * others)]
    if all(k.shape[1] % n == 0 for n in q.mesh.shape):
        strategies.append(([Shard(1)] * outputs, [Shard(1)] * tensors + [None] * others))
    return strategies


@register_sharding(torch.ops.repro_torch.flash_attention_fwd.default)
def _(q, k, v, causal, window, scale, with_lse):
    return _shardings(q, k, v, causal, window, scale, with_lse, outputs=2)


@register_sharding(torch.ops.repro_torch.flash_attention_bwd.default)
def _(q, k, v, o, lse, do, causal, window, scale):
    return _shardings(q, k, v, o, lse, do, causal, window, scale, outputs=3)


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True, window: int = 0, q_offset: int = 0,
                    scale: Optional[float] = None) -> torch.Tensor:
    """Attention of q (B, Hq, Sq, d) over k, v (B, Hkv, Skv, d), contiguous,
    f32 or bf16, Hq a multiple of Hkv (q head h reads kv head
    ``h // (Hq // Hkv)``, no repeated K/V).  Masks: keys past Skv never;
    ``col > row`` when causal; ``col <= row - window`` when ``window > 0``
    (the models' sliding window).  Scores, softmax and accumulation in f32;
    returns q's dtype and shape.  On the card d must be in
    ``HEAD_DIMS[dtype]``: 64, 128 or 256 in bf16, 16, 64 or 128 in f32;
    another raises.
    Differentiable: the gradients of q, k and v come from the backward
    kernels (their plain versions on the CPU), in the inputs' dtypes.
    DTensors of the same placements (batch or heads sharded) run the kernel
    on each rank's shard; fake tensors give shapes only.
    """
    _check(q, k, v, window, q_offset)
    _build.count(flash_attention, "calls")
    if q.device.type not in ("cpu", "cuda"):
        raise ValueError(f"flash_attention runs on cuda or cpu, not {q.device}")
    scale = float(scale if scale is not None else 1.0 / (q.shape[3] ** 0.5))
    with_lse = torch.is_grad_enabled() and any(t.requires_grad for t in (q, k, v))
    return flash_attention_fwd(q, k, v, causal, int(window), scale, with_lse)[0]


# ``calls`` counts every call on either device; ``launches`` counts forward
# CUDA kernel launches and ``bwd_launches`` backward ones (two kernels, one
# count), the card only (see kernels/block_agg/ops.py).
flash_attention.calls = 0
flash_attention.launches = 0
flash_attention.bwd_launches = 0
