"""Wrapper of the gla_chunk CUDA kernels: the forward (``csrc/gla_chunk.cu``)
and the backward (``csrc/gla_chunk_bwd.cu``), two custom operators joined
by autograd.

A CUDA tensor launches the hand-written kernels, or raises; a CPU tensor runs
the plain PyTorch versions (``ref.py``).  The tensors' device alone decides:
there is no mode switch and no fallback.  One forward call on the card is
three kernels on the current stream: per-(chunk, head) state contributions,
the scan over chunks, and per-(chunk, head) outputs; it counts as one
launch.  The scan leaves the state before each chunk in its scratch, which
the forward operator returns for the backward (three kernels, one
count).
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch
from torch.distributed.tensor import Replicate, Shard
from torch.distributed.tensor.experimental import register_sharding
from torch.utils.flop_counter import register_flop_formula

from repro_torch.kernels import _build
from repro_torch.kernels.gla_chunk.ref import gla_chunked_bwd_ref, gla_chunked_fwd_ref

# the (dk, dv) pairs each dtype's kernels, forward and backward, are built
# for: hymba's (16, 64), rwkv6's (64, 64), and the reduced configs' (8, 16)
KEY_VALUE_DIMS = {torch.bfloat16: ((16, 64), (64, 64)),
                  torch.float32: ((16, 64), (64, 64), (8, 16))}
CHUNK = 64            # steps per chunk (csrc/gla_chunk.cu kChunk)
MAX_GRID_Y = 65_535   # batch x heads ride in gridDim.y


def _check(q, k, v, g) -> None:
    if q.dim() != 4 or k.shape != q.shape or g.shape != q.shape:
        raise ValueError(f"expected q, k, g (B, H, T, dk) of one shape; got "
                         f"{tuple(q.shape)}, {tuple(k.shape)}, {tuple(g.shape)}")
    if v.dim() != 4 or v.shape[:3] != q.shape[:3]:
        raise ValueError(f"v {tuple(v.shape)} does not match q {tuple(q.shape)}")
    for what, t in (("k", k), ("v", v), ("g", g)):
        if t.dtype != q.dtype or t.device != q.device:
            raise ValueError(f"{what} is {t.dtype} on {t.device}, q {q.dtype} "
                             f"on {q.device}")
    _build.float_code(q, "q")
    for what, t in (("q", q), ("k", k), ("v", v), ("g", g)):
        if not t.is_contiguous():
            raise ValueError(f"{what} must be contiguous (B, H, T, d); call "
                             ".contiguous() on a transposed view")


def _check_widths(q, dk: int, dv: int) -> None:
    if (dk, dv) not in KEY_VALUE_DIMS[q.dtype]:
        raise ValueError(f"(dk, dv) = ({dk}, {dv}): the {str(q.dtype)[6:]} kernels "
                         f"take {KEY_VALUE_DIMS[q.dtype]}")


def _forward(q, k, v, g):
    """(o, final state, the state before each chunk (B, H, chunks, dk, dv)
    f32): the forward kernels on the card (the states are the scan pass's
    scratch), the plain version on the CPU."""
    if q.device.type == "cpu":
        return gla_chunked_fwd_ref(q, k, v, g)
    b, h, t, dk = q.shape
    dv = v.shape[-1]
    _check_widths(q, dk, dv)
    if b * h > MAX_GRID_Y:
        raise ValueError(f"{b} x {h} (batch x heads) exceeds the grid")
    if any(x.data_ptr() % 16 for x in (q, k, v, g)):
        raise ValueError("q, k, v, g must be 16-byte aligned")
    lib = _build.load("gla_chunk")
    o = torch.empty_like(v)
    state = torch.empty((b, h, dk, dv), dtype=torch.float32, device=q.device)
    # scratch of the three passes: each chunk's state contribution (then the
    # state before it) and its decay
    chunks = -(-t // CHUNK)
    ds = torch.empty((b * h, chunks, dk, dv), dtype=torch.float32, device=q.device)
    decay = torch.empty((b * h, chunks, dk), dtype=torch.float32, device=q.device)
    with torch.cuda.device(q.device):
        rc = lib.gla_chunk_launch(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), g.data_ptr(),
            o.data_ptr(), state.data_ptr(), ds.data_ptr(), decay.data_ptr(),
            _build.float_code(q, "q"), b * h, t, dk, dv,
            torch.cuda.current_stream(q.device).cuda_stream)
    _build.check(lib, "gla_chunk", rc)
    _build.count(gla_chunked, "launches")
    return o, state, ds.view(b, h, chunks, dk, dv)


def backward_checks(q, k, v, g, states, state, do, dstate, *, addresses: bool = True) -> None:
    """What the backward kernels take, checked on the host (any device):
    the forward's shapes, do like v, the chunk-start states (B, H, chunks,
    dk, dv), the final state and dstate (B, H, dk, dv) f32, all contiguous
    and 16-byte aligned (the kernels' float4 and 16-byte loads;
    ``addresses`` False skips that, for fake tensors)."""
    b, h, t, dk = q.shape
    dv = v.shape[-1]
    _check_widths(q, dk, dv)
    if b * h > MAX_GRID_Y:
        raise ValueError(f"{b} x {h} (batch x heads) exceeds the grid")
    if do.dtype != q.dtype or do.shape != v.shape:
        raise ValueError(f"the output's gradient is {tuple(do.shape)} {do.dtype}, v "
                         f"{tuple(v.shape)} {q.dtype}")
    chunks = -(-t // CHUNK)
    wants = [("states", states, (b, h, chunks, dk, dv)), ("state", state, (b, h, dk, dv))]
    if dstate is not None:
        wants.append(("dstate", dstate, (b, h, dk, dv)))
    for what, x, shape in wants:
        if tuple(x.shape) != shape or x.dtype != torch.float32:
            raise ValueError(f"{what} is {tuple(x.shape)} {x.dtype}, expected {shape} float32")
    for what, x in (("q", q), ("k", k), ("v", v), ("g", g), ("do", do), *[w[:2] for w in wants]):
        if not x.is_contiguous():
            raise ValueError(f"{what} must be contiguous")
        if addresses and x.data_ptr() % 16:
            raise ValueError(f"{what} must be 16-byte aligned")


def _backward(q, k, v, g, states, state, do, dstate):
    """(dq, dk, dv, dg): on the card the backward kernels, the chunks'
    state-gradient contributions, the reverse scan from ``dstate`` (None:
    zero), then every gradient of each chunk; on the CPU the plain
    version."""
    if q.device.type == "cpu":
        return gla_chunked_bwd_ref(q, k, v, g, states, do, dstate)
    if dstate is not None:
        dstate = dstate.float().contiguous()
    backward_checks(q, k, v, g, states, state, do, dstate)
    b, h, t, dk = q.shape
    dv = v.shape[-1]
    chunks = states.shape[2]
    lib = _build.load("gla_chunk_bwd")
    dq, dk_, dv_, dg = (torch.empty_like(x) for x in (q, k, v, g))
    # scratch: each chunk's contribution, then the gradient of the state
    # after it; its decay
    dh = torch.empty((b * h, chunks, dk, dv), dtype=torch.float32, device=q.device)
    decay = torch.empty((b * h, chunks, dk), dtype=torch.float32, device=q.device)
    with torch.cuda.device(q.device):
        rc = lib.gla_chunk_bwd_launch(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), g.data_ptr(),
            states.data_ptr(), state.data_ptr(), do.data_ptr(),
            dstate.data_ptr() if dstate is not None else None,
            dq.data_ptr(), dk_.data_ptr(), dv_.data_ptr(), dg.data_ptr(),
            dh.data_ptr(), decay.data_ptr(),
            _build.float_code(q, "q"), b * h, t, dk, dv,
            torch.cuda.current_stream(q.device).cuda_stream)
    _build.check(lib, "gla_chunk_bwd", rc)
    _build.count(gla_chunked, "bwd_launches")
    return dq, dk_, dv_, dg


# The forward and the backward are custom operators (``repro_torch::``), so
# that a DTensor and a fake tensor can call them: autograd joins the two
# through ``register_autograd`` (the forward keeps the state before each
# chunk for the backward); ``register_fake`` gives shapes and dtypes only;
# the FLOP formulas count the chunk products; the sharding rules run the
# kernels on each rank's shard of the batch or of the heads.  On a real
# tensor each op calls ``_forward`` / ``_backward``, looked up when it runs.

@torch.library.custom_op("repro_torch::gla_chunked_fwd", mutates_args=())
def gla_chunked_fwd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    g: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(o, final state, the state before each chunk (B, H, chunks, dk, dv))."""
    return _forward(q, k, v, g)


@gla_chunked_fwd.register_fake
def _(q, k, v, g):
    b, h, t, dk = q.shape
    dv = v.shape[-1]
    if q.device.type == "cuda":
        _check_widths(q, dk, dv)
    f32 = dict(dtype=torch.float32, device=q.device)
    return (torch.empty_like(v), torch.empty((b, h, dk, dv), **f32),
            torch.empty((b, h, -(-t // CHUNK), dk, dv), **f32))


@torch.library.custom_op("repro_torch::gla_chunked_bwd", mutates_args=())
def gla_chunked_bwd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, g: torch.Tensor,
                    states: torch.Tensor, state: torch.Tensor, do: torch.Tensor,
                    dstate: Optional[torch.Tensor]
                    ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]:
    """(dq, dk, dv, dg); ``dstate`` None reads as zero."""
    return _backward(q, k, v, g, states, state, do, dstate)


@gla_chunked_bwd.register_fake
def _(q, k, v, g, states, state, do, dstate):
    if q.device.type == "cuda":
        backward_checks(q, k, v, g, states, state, do,
                        None if dstate is None else dstate.float().contiguous(),
                        addresses=False)                       # a fake tensor has none
    return tuple(torch.empty_like(x) for x in (q, k, v, g))


def _setup_context(ctx, inputs, output):
    ctx.set_materialize_grads(False)
    ctx.save_for_backward(*inputs, output[2], output[1])


def _backward_rule(ctx, do, dstate, _dstates):
    q, k, v, g, states, state = ctx.saved_tensors
    do = torch.zeros_like(v) if do is None else do.contiguous()
    return gla_chunked_bwd(q, k, v, g, states, state, do, dstate)


gla_chunked_fwd.register_autograd(_backward_rule, setup_context=_setup_context)


def _chunk_flops(q_shape, dv: int, per_chunk) -> int:
    b, h, t, dk = q_shape
    c = CHUNK
    return b * h * -(-t // c) * per_chunk(c, c * (c + 1) // 2, dk, dv)


@register_flop_formula(torch.ops.repro_torch.gla_chunked_fwd)
def _(q_shape, k_shape, v_shape, g_shape, out_shape=None):
    """Per chunk of 64: the inter term and the state update (2 C dk dv
    each), the lower-triangular A (2 dk a pair) and A v (2 dv a pair)."""
    return _chunk_flops(q_shape, v_shape[-1],
                        lambda c, tri, dk, dv: 4 * c * dk * dv + 2 * tri * (dk + dv))


@register_flop_formula(torch.ops.repro_torch.gla_chunked_bwd)
def _(q_shape, k_shape, v_shape, g_shape, states_shape, state_shape, do_shape,
      dstate_shape, out_shape=None):
    """Per chunk of 64: the state-gradient contribution and the inter terms
    of dq, dk and dv (2 C dk dv each), B and dv's intra term (2 dv a pair),
    A and the intra terms of dq and dk (2 dk a pair)."""
    return _chunk_flops(q_shape, v_shape[-1],
                        lambda c, tri, dk, dv: 8 * c * dk * dv + 2 * tri * (2 * dv + 3 * dk))


def _shardings(*args, outputs: int):
    """Single-mesh-dim strategies (outputs, then inputs; None for an absent
    tensor): replicated, batch-sharded or head-sharded; every (B, H, ...)
    slice is independent."""
    present = [hasattr(a, "mesh") for a in args]
    return [([p] * outputs, [p if t else None for t in present])
            for p in (Replicate(), Shard(0), Shard(1))]


@register_sharding(torch.ops.repro_torch.gla_chunked_fwd.default)
def _(q, k, v, g):
    return _shardings(q, k, v, g, outputs=3)


@register_sharding(torch.ops.repro_torch.gla_chunked_bwd.default)
def _(q, k, v, g, states, state, do, dstate):
    return _shardings(q, k, v, g, states, state, do, dstate, outputs=4)


def gla_chunked(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                g: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Gated linear attention over q, k, g (B, H, T, dk) and v (B, H, T, dv),
    contiguous, f32 or bf16; g is the per-step log-decay, clamped to [-8, 0].
    Returns (o (B, H, T, dv) in q's dtype, final state (B, H, dk, dv) f32).
    Any T: the kernel reads steps past T as zero q, k, v and zero decay.  On
    the card (dk, dv) must be in ``KEY_VALUE_DIMS[dtype]``: (16, 64) or (64,
    64), and (8, 16) in f32; another raises.  Differentiable: the
    gradients come from the backward kernels (their plain versions on the
    CPU), in the inputs' dtypes; g's follows the reference's ``jnp.clip``,
    half a gradient on either bound.  DTensors of the same placements
    (batch or heads sharded) run the kernels on each rank's shard; fake
    tensors give shapes only.
    """
    _check(q, k, v, g)
    _build.count(gla_chunked, "calls")
    if q.device.type not in ("cpu", "cuda"):
        raise ValueError(f"gla_chunked runs on cuda or cpu, not {q.device}")
    o, state, _ = gla_chunked_fwd(q, k, v, g)
    return o, state


# ``calls`` counts every call on either device; ``launches`` counts forward
# calls that launched on the card, one per call for its three kernels, and
# ``bwd_launches`` backward ones, one per call for its three (see
# kernels/block_agg/ops.py).
gla_chunked.calls = 0
gla_chunked.launches = 0
gla_chunked.bwd_launches = 0
