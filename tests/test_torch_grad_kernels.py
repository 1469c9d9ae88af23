"""The backward of the port's two model kernels on the CPU: the plain
backward versions (``flash_attention_bwd_ref``, ``gla_chunked_bwd_ref``)
against ``torch.autograd`` through the plain forwards and against
``jax.grad`` of the reference's XLA functions (``mea_attention``,
``gla_chunked_xla``, which its training differentiates), finite differences
in f64 through the custom operators, and the model trained through them
(remat and the per-layer views change no gradient)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import layers as ref_layers
from repro.models.linear_attn import gla_chunked_xla
from repro_torch.configs import get_config
from repro_torch.kernels.flash_attn import (flash_attention, flash_attention_bwd_ref,
                                            flash_attention_lse_ref)
from repro_torch.kernels.flash_attn.ops import flash_attention_fwd
from repro_torch.kernels.gla_chunk import gla_chunked, gla_chunked_bwd_ref, gla_chunked_fwd_ref
from repro_torch.kernels.gla_chunk.ops import gla_chunked_fwd
from repro_torch.models import Model

# (Hq, Hkv, S, causal, window): GQA 1 / 2 / 4, causal, windowed, non-causal,
# a window over a non-causal mask, one query
FLASH_GRAD_CASES = [
    (4, 4, 37, True, 0),
    (4, 2, 40, True, 8),
    (4, 1, 33, True, 0),
    (6, 3, 29, False, 0),
    (2, 1, 31, False, 5),
    (3, 3, 1, True, 0),
]
# the same at gemma-7b's head dim 256: causal with S off the 64-row tile, and
# a window over GQA 2
FLASH_GRAD_WIDE_CASES = [
    (2, 2, 70, True, 0),
    (4, 2, 96, True, 40),
]

# (T, dk, dv, g low, with dstate): T off the chunk (64 and the reference's
# 32), decays past the -8 clamp, with and without a final-state gradient
GLA_GRAD_CASES = [
    (70, 8, 16, -3.0, False),
    (130, 4, 8, -12.0, True),
    (50, 8, 8, -1.0, True),
    (64, 16, 16, -0.3, False),
]


def _normal(rng, shape, dtype=np.float64, scale=1.0):
    return (rng.standard_normal(shape) * scale).astype(dtype)


def _flash_inputs(case, dtype, head_dim=16):
    hq, hkv, s, causal, window = case
    rng = np.random.default_rng(s * 7 + hq + hkv)
    q = _normal(rng, (2, hq, s, head_dim), dtype)
    k = _normal(rng, (2, hkv, s, head_dim), dtype)
    v = _normal(rng, (2, hkv, s, head_dim), dtype)
    do = _normal(rng, (2, hq, s, head_dim), dtype)
    return q, k, v, do


def _gla_inputs(case, dtype):
    t, dk, dv, lo, with_ds = case
    rng = np.random.default_rng(t + dk)
    q, k = _normal(rng, (2, 3, t, dk), dtype, 0.5), _normal(rng, (2, 3, t, dk), dtype, 0.5)
    v, do = _normal(rng, (2, 3, t, dv), dtype), _normal(rng, (2, 3, t, dv), dtype)
    g = rng.uniform(lo, 0.0, (2, 3, t, dk)).astype(dtype)
    ds = _normal(rng, (2, 3, dk, dv), dtype) if with_ds else None
    return q, k, v, g, do, ds


@pytest.mark.parametrize("case", FLASH_GRAD_CASES)
def test_flash_backward_plain_version_matches_autograd(case):
    """f64 inputs: the tile math (P from lse, delta = rowsum(do o)) against
    autograd through the dense softmax forward, to 1e-10."""
    _, _, _, causal, window = case
    q, k, v, do = (torch.from_numpy(a) for a in _flash_inputs(case, np.float64))
    q, k, v = (t.requires_grad_() for t in (q, k, v))
    o, lse = flash_attention_lse_ref(q, k, v, causal=causal, window=window)
    want = torch.autograd.grad(o, (q, k, v), do)
    got = flash_attention_bwd_ref(q.detach(), k.detach(), v.detach(), o.detach(),
                                  lse.detach(), do, causal=causal, window=window)
    for g, w in zip(got, want):
        assert g.dtype == torch.float64
        torch.testing.assert_close(g, w, rtol=1e-10, atol=1e-10)


@pytest.mark.parametrize("case,head_dim", [
    *(pytest.param(c, 16, id=f"case{i}") for i, c in enumerate(FLASH_GRAD_CASES)),
    *(pytest.param(c, 256, id=f"d256-case{i}") for i, c in enumerate(FLASH_GRAD_WIDE_CASES))])
def test_flash_backward_matches_jax_grad_of_the_reference(case, head_dim):
    """f32: the port's autograd Function (plain versions on the CPU) against
    jax.grad of the reference's mea_attention, which its training
    differentiates; sums in other orders, 2e-5 of each gradient's scale
    (at least 1: one query's dq is 0 up to f32 rounding); head dim 16, and
    256 (gemma-7b's)."""
    _, _, _, causal, window = case
    arrays = _flash_inputs(case, np.float32, head_dim)
    q, k, v = (torch.from_numpy(a).requires_grad_() for a in arrays[:3])
    o = flash_attention(q, k, v, causal=causal, window=window)
    got = torch.autograd.grad(o, (q, k, v), torch.from_numpy(arrays[3]))

    def f(q, k, v):
        out = ref_layers.mea_attention(q, k, v, causal=causal, window=window)
        return jnp.sum(out * arrays[3])

    want = jax.grad(f, argnums=(0, 1, 2))(*(jnp.asarray(a) for a in arrays[:3]))
    for g, w in zip(got, want):
        w = torch.from_numpy(np.asarray(w))
        assert g.shape == w.shape
        torch.testing.assert_close(g, w, rtol=0, atol=2e-5 * max(1.0, float(w.abs().max())))


@pytest.mark.parametrize("case", GLA_GRAD_CASES)
def test_gla_backward_plain_version_matches_autograd(case):
    """f64 inputs (no decay exactly on a bound): dq, dk, dv and dg from the
    chunk-start states and the reverse scan against autograd through the
    plain chunked forward, with and without the final state's gradient."""
    q, k, v, g, do, ds = (None if a is None else torch.from_numpy(a)
                          for a in _gla_inputs(case, np.float64))
    leaves = [t.requires_grad_() for t in (q, k, v, g)]
    o, state, states = gla_chunked_fwd_ref(*leaves)
    outs, grads_out = ([o, state], [do, ds]) if ds is not None else ([o], [do])
    want = torch.autograd.grad(outs, leaves, grads_out)
    got = gla_chunked_bwd_ref(*(t.detach() for t in leaves), states.detach(), do, ds)
    for name, a, w in zip("qkvg", got, want):
        torch.testing.assert_close(a, w, rtol=1e-9, atol=1e-9, msg=f"d{name}")


@pytest.mark.parametrize("case", GLA_GRAD_CASES)
def test_gla_backward_matches_jax_grad_of_the_reference(case):
    """f32: the port's autograd Function (chunk 64) against jax.grad of the
    reference's gla_chunked_xla (chunk 32, dif), o and the final state both
    carrying a gradient where the case has one; 1e-4 of each gradient's
    scale (dg is a long reverse sum)."""
    q, k, v, g, do, ds = _gla_inputs(case, np.float32)
    leaves = [torch.from_numpy(a).requires_grad_() for a in (q, k, v, g)]
    o, state = gla_chunked(*leaves)
    if ds is None:
        got = torch.autograd.grad([o], leaves, [torch.from_numpy(do)])
    else:
        got = torch.autograd.grad([o, state], leaves, [torch.from_numpy(do),
                                                       torch.from_numpy(ds)])

    def f(q, k, v, g):
        out, s = gla_chunked_xla(q, k, v, g)
        total = jnp.sum(out * do)
        return total + (jnp.sum(s * ds) if ds is not None else 0.0)

    want = jax.grad(f, argnums=(0, 1, 2, 3))(q, k, v, g)
    for name, a, w in zip("qkvg", got, want):
        w = torch.from_numpy(np.asarray(w))
        torch.testing.assert_close(a, w, rtol=0, atol=1e-4 * float(w.abs().max()),
                                   msg=f"d{name}")


def test_gla_decay_gradient_on_the_clamp_bounds_follows_jnp_clip():
    """g exactly -8 or 0: jnp.clip passes half the gradient (max and min
    split a tie), torch.clamp all of it.  The port follows the reference,
    whose training it must reproduce (a bf16 decay lands on -8.0 exactly
    whenever softplus rounds to 8); below -8 or above 0 nothing passes."""
    rng = np.random.default_rng(5)
    q, k = _normal(rng, (1, 2, 40, 4), np.float32, 0.5), _normal(rng, (1, 2, 40, 4), np.float32, 0.5)
    v, do = _normal(rng, (1, 2, 40, 8), np.float32), _normal(rng, (1, 2, 40, 8), np.float32)
    g = rng.uniform(-2.0, -0.1, (1, 2, 40, 4)).astype(np.float32)
    g[0, 0, 5] = -8.0
    g[0, 1, 9] = 0.0
    g[0, 0, 11, :2] = -9.5
    g[0, 1, 20, 2:] = 0.25
    leaves = [torch.from_numpy(a).requires_grad_() for a in (q, k, v, g)]
    o, _ = gla_chunked(*leaves)
    dg = torch.autograd.grad(o, leaves[3], torch.from_numpy(do))[0]

    def f(g):
        return jnp.sum(gla_chunked_xla(q, k, v, g)[0] * do)

    want = torch.from_numpy(np.asarray(jax.grad(f)(g)))
    torch.testing.assert_close(dg, want, rtol=0, atol=1e-4 * float(want.abs().max()))
    assert torch.all(dg[0, 0, 11, :2] == 0) and torch.all(dg[0, 1, 20, 2:] == 0)
    # half of what the same step passes when its decay sits just inside
    g_in = g.copy()
    g_in[0, 0, 5] = -8.0 + 1e-6
    g_in[0, 1, 9] = -1e-6
    full = torch.from_numpy(np.asarray(jax.grad(f)(g_in)))
    torch.testing.assert_close(dg[0, 0, 5], 0.5 * full[0, 0, 5], rtol=1e-3, atol=1e-6)
    torch.testing.assert_close(dg[0, 1, 9], 0.5 * full[0, 1, 9], rtol=1e-3, atol=1e-6)


def test_autograd_functions_pass_f64_finite_differences():
    """torch.autograd.gradcheck through both forward operators and their
    registered backwards on f64 CPU tensors (the plain versions keep f64):
    windowed GQA flash; GLA over two chunks with a ragged tail and decays
    past both bounds."""
    rng = np.random.default_rng(3)
    t = lambda *s, lo=None: torch.from_numpy(
        rng.uniform(lo, 0.5, s) if lo is not None else rng.standard_normal(s)).requires_grad_()
    qkv = (t(1, 4, 9, 8), t(1, 2, 9, 8), t(1, 2, 9, 8))
    assert torch.autograd.gradcheck(
        lambda q, k, v: flash_attention_fwd(q, k, v, True, 3, 0.3, True)[0], qkv)
    gla = (t(1, 2, 70, 4), t(1, 2, 70, 4), t(1, 2, 70, 3), t(1, 2, 70, 4, lo=-10.0))
    assert torch.autograd.gradcheck(lambda *x: gla_chunked_fwd(*x)[:2], gla)


def test_cpu_calls_count_no_launches():
    """On the CPU the operators take the plain versions: calls count, no
    forward or backward launch does."""
    before = (flash_attention.calls, flash_attention.launches, flash_attention.bwd_launches,
              gla_chunked.calls, gla_chunked.launches, gla_chunked.bwd_launches)
    q = torch.randn(1, 2, 8, 16, requires_grad=True)
    flash_attention(q, q.detach(), q.detach()).sum().backward()
    g = torch.full((1, 2, 8, 16), -0.5, requires_grad=True)
    gla_chunked(q, q.detach(), q.detach(), g)[0].sum().backward()
    after = (flash_attention.calls, flash_attention.launches, flash_attention.bwd_launches,
             gla_chunked.calls, gla_chunked.launches, gla_chunked.bwd_launches)
    assert [a - b for a, b in zip(after, before)] == [1, 0, 0, 1, 0, 0]


@pytest.mark.parametrize("arch", ["internlm2-1.8b", "hymba-1.5b"])
def test_remat_and_layer_views_leave_the_gradients_unchanged(arch):
    """A reduced model's loss gradients with cfg.remat (each block under
    torch.utils.checkpoint, its forward run again in the backward: flash and
    GLA called twice per layer) are bitwise those without; and the stacked
    gradients are those of indexing each layer with t[i]."""
    import dataclasses
    cfg = get_config(arch).reduced()
    tokens = torch.from_numpy(np.random.default_rng(0).integers(0, cfg.vocab_size, (2, 24)))
    grads, calls = [], []
    for remat in (True, False):
        model = Model(dataclasses.replace(cfg, remat=remat), device="cpu")
        model.init(torch.Generator().manual_seed(3)).requires_grad_(True)
        before = flash_attention.calls
        logits, _ = model({"tokens": tokens})
        loss = logits.float().square().mean()
        grads.append(torch.autograd.grad(loss, list(model.parameters())))
        calls.append(flash_attention.calls - before)
    for a, b in zip(*grads):
        assert torch.equal(a, b)
    assert calls == [2 * cfg.num_layers, cfg.num_layers]  # recomputed in the backward
    # the stacked gradients are those of per-layer indexing
    model._per_layer = lambda: [{n: t[i] for n, t in model.layers.items()}
                                for i in range(cfg.num_layers)]
    logits, _ = model({"tokens": tokens})
    indexed = torch.autograd.grad(logits.float().square().mean(), list(model.parameters()))
    for a, b in zip(grads[1], indexed):
        torch.testing.assert_close(a, b, rtol=1e-6, atol=1e-8)
