"""Plain PyTorch versions of gla_chunk, forward and backward (the CPU route
and the kernels' yardstick in tests and ``chip_smoke.py``): the vectorised
chunked ``dif`` form of the reference's ``models/linear_attn.py``
``gla_chunked_xla``."""

from __future__ import annotations

import torch
import torch.nn.functional as F

G_CLAMP = -8.0  # per-step log-decay floor: keeps within-chunk ratios bounded
CHUNK = 64      # the kernel's chunk


def _wide(x: torch.Tensor) -> torch.Tensor:
    """x in f32, or f64 kept (the finite-difference checks)."""
    return x.to(torch.promote_types(x.dtype, torch.float32))


def _padded(xs, t: int, chunk: int):
    pad = (-t) % chunk
    return [F.pad(x, (0, 0, 0, pad)) for x in xs] if pad else list(xs)


def gla_chunked_fwd_ref(q, k, v, g, *, chunk: int = CHUNK):
    """:func:`gla_chunked_ref` and the state before each chunk, (B, H,
    chunks, dk, dv) f32: what the backward reads."""
    b, h, t, dk = q.shape
    dv = v.shape[-1]
    qf, kf, vf, gf = _padded([_wide(q), _wide(k), _wide(v),
                              _wide(g).clamp(G_CLAMP, 0.0)], t, chunk)
    tri = torch.ones((chunk, chunk), dtype=torch.bool, device=q.device).tril()
    state = torch.zeros((b, h, dk, dv), dtype=qf.dtype, device=q.device)
    outs, states = [], []
    for c0 in range(0, qf.shape[2], chunk):
        qi, ki, vi, gi = (x[:, :, c0:c0 + chunk] for x in (qf, kf, vf, gf))
        states.append(state)
        L = gi.cumsum(dim=2)                                   # decreasing
        L_last = L[:, :, -1:, :]
        inter = torch.matmul(qi * torch.exp(L), state)
        dif = L[:, :, :, None, :] - L[:, :, None, :, :]        # (b,h,C,C,dk)
        dif = dif.masked_fill(~tri[:, :, None], float("-inf"))  # before exp
        attn = (qi[:, :, :, None, :] * ki[:, :, None, :, :]
                * torch.exp(dif)).sum(dim=-1)
        intra = torch.matmul(attn, vi)
        k_carry = ki * torch.exp(L_last - L)
        state = (state * torch.exp(L_last).transpose(-1, -2)
                 + torch.matmul(k_carry.transpose(-1, -2), vi))
        outs.append(inter + intra)
    o = torch.cat(outs, dim=2)[:, :, :t]
    return o.to(q.dtype), state, torch.stack(states, dim=2)


def gla_chunked_ref(q, k, v, g, *, chunk: int = CHUNK):
    """q, k, g (B, H, T, dk); v (B, H, T, dv).  Returns (o (B, H, T, dv) in
    q's dtype, final state (B, H, dk, dv) f32) of the recurrence
    ``S_t = diag(e^{g_t}) S_{t-1} + k_t v_t^T``, ``o_t = S_t^T q_t``, with g
    clamped to [-8, 0] and T padded with zero steps.  Within a chunk every
    exponent is <= 0: the (C, C, dk) relative decays are masked before exp.
    """
    o, state, _ = gla_chunked_fwd_ref(q, k, v, g, chunk=chunk)
    return o, state


def gla_recurrent_ref(q, k, v, g, *, initial_state=None):
    """q, k, g (T, dk); v (T, dv): the recurrence ``S_t = diag(e^{g_t})
    S_{t-1} + k_t v_t^T``, ``o_t = S_t^T q_t`` one step at a time in f32,
    from ``initial_state`` (dk, dv) or zeros; g as given (no clamp).  The
    reference's sequential oracle (``kernels/gla_chunk/ref.py``), independent
    of chunking.  Returns (o (T, dv) in q's dtype, final state f32)."""
    qf, kf, vf, gf = (x.to(torch.float32) for x in (q, k, v, g))
    S = (torch.zeros((q.shape[1], v.shape[1]), dtype=torch.float32, device=q.device)
         if initial_state is None else initial_state.to(torch.float32))
    outs = []
    for t in range(q.shape[0]):
        S = S * torch.exp(gf[t])[:, None] + kf[t][:, None] * vf[t][None, :]
        outs.append(S.T @ qf[t])
    return torch.stack(outs).to(q.dtype), S


def clamp_grad(g: torch.Tensor) -> torch.Tensor:
    """d clamp(g, -8, 0) / dg in f32 as the reference's ``jnp.clip``
    differentiates it: 1 inside, 0 outside, and 0.5 on either bound, where
    ``max`` / ``min`` split a tie between their two arguments."""
    gf = _wide(g)
    inside = ((gf > G_CLAMP) & (gf < 0.0)).to(gf.dtype)
    ties = ((gf == G_CLAMP) | (gf == 0.0)).to(gf.dtype)
    return inside + 0.5 * ties


def gla_chunked_bwd_ref(q, k, v, g, states, do, dstate, *, chunk: int = CHUNK):
    """The gradients (dq, dk, dv, dg) of :func:`gla_chunked_ref`, in the
    inputs' dtypes, from the chunk-start ``states`` (B, H, chunks, dk, dv)
    f32 of the forward, the output's gradient ``do`` and the final state's
    ``dstate`` (None reads as zero), by the kernel's chunked math in f32
    (f64 inputs stay f64).

    Per chunk, with L the cumulative clamped decay, S0 the state before it
    and dH the gradient of the state after it (a reverse scan from
    ``dstate``: dH_{c-1} = e^{L_C} dH_c + (q e^L)^T do),
    ``B[i, j] = do_i . v_j`` and ``A[i, j] = sum_x q_ix k_jx e^{L_ix - L_jx}``
    for j <= i (every exponent <= 0, masked before exp):

        dq_i = e^{L_i} (S0 do_i) + sum_{j<=i} B_ij e^{L_i - L_j} k_j
        dk_j = sum_{i>=j} B_ij e^{L_i - L_j} q_i + e^{L_C - L_j} (dH v_j)
        dv_j = sum_{i>=j} A_ij do_i + (k_j e^{L_C - L_j})^T dH

    and dg, per key channel, the reverse cumulative sum over time of
    ``q dq - k dk`` plus ``<S_T, dstate>`` (taken in the kernel's order:
    within each chunk, then each later chunk's total), times
    :func:`clamp_grad`.
    """
    b, h, t, dk = q.shape
    dv = v.shape[-1]
    qf, kf, vf, dof = _padded([_wide(q), _wide(k), _wide(v), _wide(do)], t, chunk)
    gf, = _padded([_wide(g).clamp(G_CLAMP, 0.0)], t, chunk)
    states = _wide(states)
    n = qf.shape[2] // chunk
    split = lambda x: x.view(b, h, n, chunk, x.shape[-1])
    qc, kc, vc, dc = (split(x) for x in (qf, kf, vf, dof))
    L = split(gf).cumsum(dim=3)                                 # (b,h,n,C,dk)
    L_last = L[:, :, :, -1:, :]
    # the gradient of the state after each chunk, by a reverse scan
    contrib = torch.matmul((qc * torch.exp(L)).transpose(-1, -2), dc)
    decay = torch.exp(L_last).transpose(-1, -2)                # (b,h,n,dk,1)
    dh = [None] * n
    acc = (_wide(dstate) if dstate is not None
           else torch.zeros((b, h, dk, dv), dtype=qf.dtype, device=q.device))
    for c in range(n - 1, -1, -1):
        dh[c] = acc
        acc = acc * decay[:, :, c] + contrib[:, :, c]
    dH = torch.stack(dh, dim=2)                                 # (b,h,n,dk,dv)

    tri = torch.ones((chunk, chunk), dtype=torch.bool, device=q.device).tril()
    dif = L[..., :, None, :] - L[..., None, :, :]              # (b,h,n,C,C,dk)
    E = torch.exp(dif.masked_fill(~tri[:, :, None], float("-inf")))
    Bm = torch.matmul(dc, vc.transpose(-1, -2)).masked_fill(~tri, 0.0)
    Am = (qc[..., :, None, :] * kc[..., None, :, :] * E).sum(dim=-1)
    ekc = torch.exp(L_last - L)                                 # e^{L_C - L_j}
    dq = (torch.exp(L) * torch.matmul(dc, states.transpose(-1, -2))
          + (Bm[..., None] * E * kc[..., None, :, :]).sum(dim=4))
    dk_ = ((Bm[..., None] * E * qc[..., :, None, :]).sum(dim=3)
           + ekc * torch.matmul(vc, dH.transpose(-1, -2)))
    dv_ = (torch.matmul(Am.transpose(-1, -2), dc)
           + torch.matmul(kc * ekc, dH))

    # dg: within-chunk reverse sums, then every later chunk's total
    r = qc * dq - kc * dk_
    local = r.flip(3).cumsum(dim=3).flip(3)                     # (b,h,n,C,dk)
    later = torch.zeros((b, h, dk), dtype=qf.dtype, device=q.device)
    if dstate is not None:
        s_end = (states[:, :, -1] * decay[:, :, -1]
                 + torch.matmul((kc[:, :, -1] * ekc[:, :, -1]).transpose(-1, -2),
                                vc[:, :, -1]))
        later = (s_end * _wide(dstate)).sum(dim=-1)
    suffix = [None] * n
    for c in range(n - 1, -1, -1):
        suffix[c] = later
        later = later + local[:, :, c, 0]
    dg = local + torch.stack(suffix, dim=2)[:, :, :, None, :]

    merge = lambda x: x.reshape(b, h, n * chunk, x.shape[-1])[:, :, :t]
    dg = merge(dg) * clamp_grad(g)
    return (merge(dq).to(q.dtype), merge(dk_).to(k.dtype), merge(dv_).to(v.dtype),
            dg.to(g.dtype))
