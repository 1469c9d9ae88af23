"""Top-k mixture-of-experts FFN of the port: the reference's
``models/moe.py``, with no Pallas original (XLA einsums there, torch ops and
``torch.matmul`` here).

``moe_ffn`` is the sort-based dispatch into static-capacity expert buffers:

  1. route: top-k softmax gates per token;
  2. sort the (token, expert-slot) pairs by expert id, stably;
  3. each pair's position within its expert from a cumulative count;
  4. copy the kept pairs' activations into an (E * capacity, D) buffer (a
     pair past its expert's capacity is dropped: the dropped slot
     ``E * capacity`` reads zeros);
  5. the expert FFNs as batched products over the expert axis;
  6. gather back, scale by the gates and combine.

Three choices keep the port's routing the reference's, token for token:
the top-k keeps the lower expert index first among equal probabilities
(``jax.lax.top_k``'s order; ``torch.topk`` promises none), the sort is
stable (``jnp.argsort`` is), and the combine sums each token's K pair
outputs in slot order instead of an ``index_add_``, whose atomics on the
card add in no repeatable order.

``moe_ffn_dense`` is the dropless decode route: every expert on every token,
combined with the sparse top-k gates.
"""

from __future__ import annotations

from typing import Tuple

import torch
import torch.nn.functional as F


def _act(h: torch.Tensor, mlp_kind: str) -> torch.Tensor:
    return F.silu(h) if mlp_kind == "swiglu" else F.gelu(h, approximate="tanh")


def _route(x, router_w, top_k: int):
    """(probs (T, E) f32, normalized gates (T, K) f32, experts (T, K))."""
    probs = torch.softmax(x.float() @ router_w.float(), dim=-1)
    # a stable descending sort: equal probabilities keep the lower expert first
    gate_vals, expert_idx = torch.sort(probs, dim=-1, descending=True, stable=True)
    gate_vals, expert_idx = gate_vals[:, :top_k], expert_idx[:, :top_k]
    gate_vals = gate_vals / gate_vals.sum(-1, keepdim=True).clamp(min=1e-9)
    return probs, gate_vals, expert_idx


def moe_ffn(x, router_w, w1, w3, w2, *, top_k: int, capacity_factor: float,
            mlp_kind: str = "swiglu") -> Tuple[torch.Tensor, torch.Tensor]:
    """x (T, D); router_w (D, E); w1, w3 (E, D, F); w2 (E, F, D).  Returns
    (out (T, D) in x's dtype, the Switch aux loss () f32)."""
    t, d = x.shape
    e = router_w.shape[1]
    probs, gate_vals, expert_idx = _route(x, router_w, top_k)

    # Switch aux loss: E * sum_e f_e * p_e
    flat_expert = expert_idx.reshape(-1)                            # (T*K,)
    counts = torch.bincount(flat_expert, minlength=e)
    aux = e * torch.sum(probs.mean(dim=0) * (counts.float() / (t * top_k)))

    capacity = max(int(t * top_k * capacity_factor / e), top_k)
    flat_token = torch.arange(t, device=x.device).repeat_interleave(top_k)
    order = torch.argsort(flat_expert, stable=True)
    se, st_tok = flat_expert[order], flat_token[order]
    sg = gate_vals.reshape(-1)[order]
    starts = torch.cumsum(counts, 0) - counts                       # (E,)
    pos_in_expert = torch.arange(t * top_k, device=x.device) - starts[se]
    keep = pos_in_expert < capacity
    dest = torch.where(keep, se * capacity + pos_in_expert,
                       torch.full_like(se, e * capacity))

    buf = torch.zeros(e * capacity + 1, d, dtype=x.dtype, device=x.device)
    buf[dest[keep]] = x[st_tok[keep]]
    buf = buf[:-1].view(e, capacity, d)
    act = _act(torch.bmm(buf, w1), mlp_kind) * torch.bmm(buf, w3)
    out_buf = torch.bmm(act, w2).view(e * capacity, d)
    out_buf = torch.cat([out_buf, out_buf.new_zeros(1, d)])

    y_pairs = out_buf[dest] * (sg * keep)[:, None].to(x.dtype)      # sorted order
    per_slot = torch.empty_like(y_pairs)
    per_slot[order] = y_pairs                                       # (T*K, D), token-major
    per_slot = per_slot.view(t, top_k, d)
    y = per_slot[:, 0]
    for j in range(1, top_k):
        y = y + per_slot[:, j]
    return y, aux


def moe_ffn_dense(x, router_w, w1, w3, w2, *, top_k: int,
                  mlp_kind: str = "swiglu") -> torch.Tensor:
    """Dropless decode route: every expert on every token, combined with the
    sparse top-k gates.  x (T, D); returns (T, D) in x's dtype."""
    t = x.shape[0]
    e = router_w.shape[1]
    _, gate_vals, expert_idx = _route(x, router_w, top_k)
    gates = torch.zeros(t, e, dtype=torch.float32, device=x.device)
    gates.scatter_(1, expert_idx, gate_vals)
    act = _act(torch.matmul(x, w1), mlp_kind) * torch.matmul(x, w3)  # (E, T, F)
    y_e = torch.matmul(act, w2)                                      # (E, T, D)
    return torch.einsum("etd,te->td", y_e, gates.to(x.dtype))
