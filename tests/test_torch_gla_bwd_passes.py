"""The three passes of the gla_chunk backward kernels, held on the CPU.

``csrc/gla_chunk_bwd.cu`` splits the backward into a per-(chunk, head) pass
(each chunk's state-gradient contribution and decay), a reverse scan over
the chunks (the gradient of the state after each chunk), and one
per-(chunk, head) pass for every gradient of the chunk: the intra-chunk sums
by the forward's sub-block re-basing (SUB = 16: exps per term only on the
diagonal sub-blocks, every off-diagonal pair re-based at a sub-block's last
step), and dg's sum over later steps taken as ``<S1, dH>``, the state after
the chunk against the gradient that reaches it, so no chunk waits for
another's totals.  ``three_bwd_passes`` below is a plain PyTorch mirror of
that split, slab by slab of 16 key channels as the kernel walks them; it is
held against the port's plain backward and ``jax.grad`` of the reference's
``gla_chunked_xla``, so the decomposition's algebra is checked without a
card.  Inputs come from numpy seeds and reach both packages as numpy
arrays.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from repro.models.linear_attn import gla_chunked_xla
from repro_torch.kernels.gla_chunk import gla_chunked_bwd_ref, gla_chunked_fwd_ref
from repro_torch.kernels.gla_chunk.ops import CHUNK
from repro_torch.kernels.gla_chunk.ref import G_CLAMP, clamp_grad

SUB = 16   # the sub-block of the re-basing
SLAB = 16  # key channels per slab


def three_bwd_passes(q, k, v, g, states, state, do, dstate, chunk=CHUNK, sub=SUB):
    """(dq, dk, dv, dg) of the gla_chunk backward kernels' three passes, in
    the inputs' float type (f32 or f64)."""
    b, h, t, dk = q.shape
    dv = v.shape[-1]
    pad = (-t) % chunk
    qc, kc, vc, gc, dc = (F.pad(x, (0, 0, 0, pad)).reshape(b, h, -1, chunk, x.shape[-1])
                          for x in (q, k, v, g, do))
    n = qc.shape[2]
    L = gc.clamp(G_CLAMP, 0.0).cumsum(dim=3)                  # (b, h, n, C, dk)
    L_last = L[..., -1:, :]

    # pass 1: each chunk's contribution (q e^L)^T dO and its decay
    contrib = torch.matmul((qc * torch.exp(L)).transpose(-1, -2), dc)
    decay = torch.exp(L_last).transpose(-1, -2)                # (b, h, n, dk, 1)

    # pass 2: the gradient of the state after each chunk, from the last
    s = dstate if dstate is not None else torch.zeros((b, h, dk, dv), dtype=q.dtype)
    dh = [None] * n
    for c in range(n - 1, -1, -1):
        dh[c] = s
        s = s * decay[:, :, c] + contrib[:, :, c]
    dH = torch.stack(dh, dim=2)                                # (b, h, n, dk, dv)
    after = torch.cat([states[:, :, 1:], state[:, :, None]], dim=2)

    # pass 3, per chunk: B; slab by slab dq, dk, dg and A's and dv's parts;
    # then dv's intra term
    ends = [r * sub + sub - 1 for r in range(chunk // sub)]   # b(cb)
    Bm = torch.matmul(dc, vc.transpose(-1, -2))
    A = torch.zeros((b, h, n, chunk, chunk), dtype=q.dtype)
    dq, dk_, dg = (torch.zeros_like(qc) for _ in range(3))
    dv_ = torch.zeros_like(vc)
    tri = torch.ones((sub, sub), dtype=torch.bool).tril()
    for x0 in range(0, dk, SLAB):
        xs = slice(x0, x0 + SLAB)
        qx, kx, Lx, Lc = qc[..., xs], kc[..., xs], L[..., xs], L_last[..., xs]
        inter_q = torch.matmul(dc, states[..., xs, :].transpose(-1, -2))
        inter_k = torch.matmul(vc, dH[..., xs, :].transpose(-1, -2))
        gq = torch.exp(Lx) * inter_q
        gk = torch.exp(Lc - Lx) * inter_k
        for r in range(chunk // sub):
            rows = slice(r * sub, (r + 1) * sub)
            Lr = Lx[..., rows, :]
            # diagonal sub-block: e^{L_i - L_j} for j <= i only, masked before exp
            dif = Lr[..., :, None, :] - Lr[..., None, :, :]
            E = torch.exp(dif.masked_fill(~tri[:, :, None], float("-inf")))
            Bd = Bm[..., rows, rows]
            A[..., rows, rows] += (qx[..., rows, None, :] * kx[..., None, rows, :] * E).sum(-1)
            gq[..., rows, :] += (Bd[..., None] * E * kx[..., None, rows, :]).sum(-2)
            gk[..., rows, :] += (Bd[..., None] * E * qx[..., rows, None, :]).sum(-3)
            if r > 0:
                # dq: rows of sub-block r against every earlier step j <= a,
                # re-based at a = b(r - 1)
                a = ends[r - 1]
                La = Lx[..., a:a + 1, :]
                kr = kx[..., :a + 1, :] * torch.exp(La - Lx[..., :a + 1, :])
                gq[..., rows, :] += torch.exp(Lr - La) * torch.matmul(Bm[..., rows, :a + 1], kr)
            for cb in range(r):
                cols = slice(cb * sub, (cb + 1) * sub)
                Lb = Lx[..., ends[cb]:ends[cb] + 1, :]
                qq = qx[..., rows, :] * torch.exp(Lr - Lb)
                kb = kx[..., cols, :] * torch.exp(Lb - Lx[..., cols, :])
                A[..., rows, cols] += torch.matmul(qq, kb.transpose(-1, -2))
        for cb in range(chunk // sub - 1):
            # dk: columns of sub-block cb against every later step i > b
            cols = slice(cb * sub, (cb + 1) * sub)
            bnd = ends[cb]
            Lb = Lx[..., bnd:bnd + 1, :]
            qq = qx[..., bnd + 1:, :] * torch.exp(Lx[..., bnd + 1:, :] - Lb)
            gk[..., cols, :] += torch.exp(Lb - Lx[..., cols, :]) * torch.matmul(
                Bm[..., bnd + 1:, cols].transpose(-1, -2), qq)
        dq[..., xs], dk_[..., xs] = gq, gk
        # dg: within-chunk reverse sums plus <S1, dH> per channel
        rr = qx * gq - kx * gk
        local = rr.flip(3).cumsum(dim=3).flip(3)
        suffix = (after[..., xs, :] * dH[..., xs, :]).sum(-1)  # (b, h, n, slab)
        dg[..., xs] = local + suffix[..., None, :]
        # dv's inter term over the slab's channels
        dv_ += torch.matmul((kx * torch.exp(Lc - Lx)), dH[..., xs, :])
    A = A * torch.ones((chunk, chunk), dtype=torch.bool).tril()
    dv_ += torch.matmul(A.transpose(-1, -2), dc)

    merge = lambda x: x.reshape(b, h, n * chunk, x.shape[-1])[:, :, :t]
    return merge(dq), merge(dk_), merge(dv_), merge(dg) * clamp_grad(g)


# (B, H, T, dk, dv, g low, with dstate): hymba's (16, 64) and rwkv6's (64,
# 64) (four slabs); T off the chunk; decays past the -8 clamp
CASES = [
    (1, 2, 130, 16, 64, -3.0, True),
    (2, 1, 200, 64, 64, -12.0, False),
    (1, 3, 64, 16, 64, -0.5, False),
    (1, 2, 70, 32, 16, -9.0, True),
]


def _inputs(case, dtype):
    b, h, t, dk, dv, lo, with_ds = case
    rng = np.random.default_rng(t + dk + h)
    q = (rng.standard_normal((b, h, t, dk)) * 0.5).astype(dtype)
    k = (rng.standard_normal((b, h, t, dk)) * 0.5).astype(dtype)
    v = rng.standard_normal((b, h, t, dv)).astype(dtype)
    do = rng.standard_normal((b, h, t, dv)).astype(dtype)
    g = rng.uniform(lo, 0.0, (b, h, t, dk)).astype(dtype)
    g[..., 3, :] = -8.0
    g[..., 4, :] = 0.0
    ds = rng.standard_normal((b, h, dk, dv)).astype(dtype) if with_ds else None
    return q, k, v, g, do, ds


@pytest.mark.parametrize("case", CASES)
def test_three_bwd_passes_match_the_plain_backward(case):
    """f64: the kernels' decomposition (re-based sub-blocks, dg from
    <S1, dH>) against the port's plain backward (the dif form, dg from every
    later chunk's total) on the same chunk-start states, to 1e-10."""
    q, k, v, g, do, ds = (None if a is None else torch.from_numpy(a)
                          for a in _inputs(case, np.float64))
    _, state, states = gla_chunked_fwd_ref(q, k, v, g)
    got = three_bwd_passes(q, k, v, g, states, state, do, ds)
    want = gla_chunked_bwd_ref(q, k, v, g, states, do, ds)
    for name, a, w in zip("qkvg", got, want):
        torch.testing.assert_close(a, w, rtol=1e-10, atol=1e-10, msg=f"d{name}")


@pytest.mark.parametrize("case", CASES)
def test_three_bwd_passes_match_jax_grad_of_the_reference(case):
    """f32: the kernels' decomposition against jax.grad of the reference's
    gla_chunked_xla, which its training differentiates (chunk 32, dif);
    1e-4 of each gradient's scale, as the plain version is held."""
    arrays = _inputs(case, np.float32)
    q, k, v, g, do, ds = (None if a is None else torch.from_numpy(a) for a in arrays)
    _, state, states = gla_chunked_fwd_ref(q, k, v, g)
    got = three_bwd_passes(q, k, v, g, states, state, do, ds)

    def f(q, k, v, g):
        out, s = gla_chunked_xla(q, k, v, g)
        total = jnp.sum(out * arrays[4])
        return total + (jnp.sum(s * arrays[5]) if arrays[5] is not None else 0.0)

    want = jax.grad(f, argnums=(0, 1, 2, 3))(*arrays[:4])
    for name, a, w in zip("qkvg", got, want):
        w = torch.from_numpy(np.asarray(w))
        torch.testing.assert_close(a, w, rtol=0, atol=1e-4 * float(w.abs().max()),
                                   msg=f"d{name}")
