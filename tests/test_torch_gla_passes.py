"""The three passes of the gla_chunk CUDA kernels, held on the CPU.

``csrc/gla_chunk.cu`` splits the chunked recurrence into a per-(chunk, head)
pass (each chunk's own state contribution and decay), a scan over the chunks
(the state before each chunk), and a per-(chunk, head) output pass (the
two-level SUB = 16 intra-chunk term plus the inter-chunk term from the state
before the chunk).  ``three_passes`` below is a plain PyTorch mirror of that
split; it is held against the reference's Pallas kernel (interpret mode) and
the port's plain version, so the decomposition's algebra is checked without
a card.  Inputs come from numpy seeds and reach both packages as numpy
arrays.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from repro.kernels.gla_chunk import gla_chunked as ref_gla_chunked
from repro_torch.kernels.gla_chunk import gla_chunked_ref
from repro_torch.kernels.gla_chunk.ops import CHUNK
from repro_torch.kernels.gla_chunk.ref import G_CLAMP

SUB = 16  # the output pass's sub-block


def three_passes(q, k, v, g, chunk=CHUNK, sub=SUB):
    """(o, final state) of the gla_chunk kernels' three passes, in f32."""
    b, h, t, dk = q.shape
    dv = v.shape[-1]
    pad = (-t) % chunk
    qc, kc, vc, gc = (F.pad(x.float(), (0, 0, 0, pad)).reshape(b, h, -1, chunk, x.shape[-1])
                      for x in (q, k, v, g))
    n = qc.shape[2]
    L = gc.clamp(G_CLAMP, 0.0).cumsum(dim=3)                  # (b, h, n, C, dk)
    L_last = L[..., -1:, :]

    # pass 1, per (chunk, head): the chunk's own contribution and its decay
    ds = torch.matmul((kc * torch.exp(L_last - L)).transpose(-1, -2), vc)
    decay = torch.exp(L_last).transpose(-1, -2)               # (b, h, n, dk, 1)

    # pass 2, per state element: the state before each chunk
    s = torch.zeros((b, h, dk, dv))
    before = []
    for c in range(n):
        before.append(s)
        s = s * decay[:, :, c] + ds[:, :, c]
    s_before = torch.stack(before, dim=2)                     # (b, h, n, dk, dv)

    # pass 3, per (chunk, head): (q e^L) S_before + A v, every exponent <= 0
    inter = torch.matmul(qc * torch.exp(L), s_before)
    intra = torch.zeros_like(inter)
    tri = torch.ones((sub, sub), dtype=torch.bool).tril()
    for r in range(chunk // sub):
        rows = slice(r * sub, (r + 1) * sub)
        qr, Lr = qc[..., rows, :], L[..., rows, :]
        for cb in range(r + 1):
            cols = slice(cb * sub, (cb + 1) * sub)
            kcb, Lc = kc[..., cols, :], L[..., cols, :]
            if cb < r:  # re-based at the column sub-block's last step
                base = L[..., (cb + 1) * sub - 1:(cb + 1) * sub, :]
                a = torch.matmul(qr * torch.exp(Lr - base),
                                 (kcb * torch.exp(base - Lc)).transpose(-1, -2))
            else:       # diagonal: masked before exp
                dif = Lr[..., :, None, :] - Lc[..., None, :, :]
                dif = dif.masked_fill(~tri[:, :, None], float("-inf"))
                a = (qr[..., :, None, :] * kcb[..., None, :, :] * torch.exp(dif)).sum(-1)
            intra[..., rows, :] += torch.matmul(a, vc[..., cols, :])
    o = (inter + intra).reshape(b, h, n * chunk, dv)[:, :, :t]
    return o, s


def _inputs(seed, t, dk, dv):
    rng = np.random.default_rng(seed)
    q = rng.normal(0, 1, (1, 2, t, dk)).astype(np.float32)
    k = rng.normal(0, 1, (1, 2, t, dk)).astype(np.float32)
    v = rng.normal(0, 1, (1, 2, t, dv)).astype(np.float32)
    g = -rng.uniform(0.001, 0.2, (1, 2, t, dk)).astype(np.float32)
    g[:, :, 5:9] = -9.5                       # below the clamp, in chunk 0
    g[:, 1, t - 20:t - 17, : dk // 2] = -30.0  # and in the last chunk
    return q, k, v, g


@pytest.mark.parametrize("t", [100, 200])
@pytest.mark.parametrize("dk,dv", [(16, 64), (64, 64)])
def test_three_passes_match_the_pallas_kernel_and_the_plain_version(t, dk, dv):
    """o and the final state of the three passes against the reference's
    Pallas kernel in interpret mode (f32, chunk 64) and the port's plain
    version at rtol = atol = 1e-4: f32 sums of the same terms in other orders
    (measured: |diff| at most 2.3e-4 where |o| reaches 114, and the state
    equal to the plain version's bit for bit); T off the chunk (a ragged last
    chunk) and decays past -8."""
    q, k, v, g = _inputs(t + dk, t, dk, dv)
    o, s = three_passes(*(torch.from_numpy(x) for x in (q, k, v, g)))
    assert o.shape == (1, 2, t, dv) and s.shape == (1, 2, dk, dv)
    want_o, want_s = ref_gla_chunked(*(jnp.asarray(x) for x in (q, k, v, g)),
                                     chunk=64, interpret=True)
    plain_o, plain_s = gla_chunked_ref(*(torch.from_numpy(x) for x in (q, k, v, g)))
    for wo, ws in ((np.asarray(want_o), np.asarray(want_s)),
                   (plain_o.numpy(), plain_s.numpy())):
        np.testing.assert_allclose(o.numpy(), wo, rtol=1e-4, atol=1e-4)
        np.testing.assert_allclose(s.numpy(), ws, rtol=1e-4, atol=1e-4)


def test_scan_carries_the_state_across_chunks():
    """The inter-chunk term is what links the passes: dropping the scan
    (every chunk starting from a zero state) changes o past the first
    chunk, and leaves the first chunk's outputs exactly as they were."""
    q, k, v, g = (torch.from_numpy(x) for x in _inputs(7, 200, 16, 64))
    o, _ = three_passes(q, k, v, g)
    alone = torch.cat([three_passes(*(x[:, :, c:c + CHUNK] for x in (q, k, v, g)))[0]
                       for c in range(0, 200, CHUNK)], dim=2)
    assert torch.equal(o[:, :, :CHUNK], alone[:, :, :CHUNK])
    assert (o[:, :, CHUNK:] - alone[:, :, CHUNK:]).abs().max() > 1e-2
