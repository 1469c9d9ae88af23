"""Top-k mixture-of-experts FFN of the port: the reference's
``models/moe.py``, with no Pallas original (XLA einsums there, torch ops and
``torch.bmm`` / ``torch.matmul`` here).

``moe_ffn`` is the sort-based dispatch into static-capacity expert buffers:

  1. route: top-k softmax gates per token;
  2. sort the (token, expert-slot) pairs by expert id, stably;
  3. each pair's position within its expert from a cumulative count;
  4. copy the pairs' activations into an (E * capacity + 1, D) buffer (a
     pair past its expert's capacity is dropped into the last row, which
     the FFN never reads, and its output reads zeros there);
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

On a device mesh (x a DTensor) both run expert-parallel, in the layout of
``train/sharding.py``: experts E over the ``model`` axis (M ranks), d_model
over the data axes (``pod``, ``data``: P ranks in all), tokens by rows over
the data axes.  Rank (d, m) keeps T_d = T / P rows and E_m = E / M experts.
Where P does not divide T the rows are replicated (P counts as 1), where M
does not divide E the experts are (M counts as 1), and every rank then does
what GSPMD would do with the reference's specs: the same work as its
replicas.  Every shape is known before the data, as the dry run's fake
trace needs.  ``moe_ffn`` on a mesh:

  * route: rank (d, m) routes its T_d / R rows, R = M where M divides T_d
    (else 1); the K experts of its data rank's T_d rows are all-gathered
    over ``model`` (T_d * K int64);
  * count: each data rank's per-expert counts are all-gathered over the
    data axes (P * E int64); a pair's position in its expert is the count
    over the lower data ranks plus its stable local position, the global
    ``argsort(flat_expert, stable=True)``'s; capacity C from the global T,
    the reference's ``max(int(T * K * cf / E), K)``, so drops are the
    unsharded run's; the aux loss from the global counts and the global
    ``probs.mean(0)`` (P * R means of E f32 all-gathered);
  * dispatch: rank (d, m) multiplies its E_m experts over capacity rows
    [d * C_p, (d + 1) * C_p), C_p = ceil(C / P) (C padded to P * C_p with
    rows never filled).  Each rank scatters its own rows' pairs of expert
    group m into one (E_m, C_p, D) block per data rank and exchanges the
    blocks in one all-to-all over the data axes (E_m * P * C_p * D
    elements out and in); a slot takes its row from the one data rank
    whose pairs own it;
  * the expert weights: E_m experts' D shards all-gathered over the data
    axes only (3 * E_m * D * F elements; their gradients reduce-scattered
    back, placed as the parameters: no rank forms an (E, D, F) gradient);
  * back: the (E_m, C_p, D) outputs all-gathered over the data axes
    (E_m * P * C_p * D), each rank reads its pairs' rows, then one
    all-to-all over ``model`` (T_d * K * D) brings each rank's T_d / R
    rows the K slot outputs from the ranks that own their experts (with R =
    1: an all-gather of M * T_d * K * D).  The combine scales by the gates
    and sums slots 0..K-1 in order on each rank's own rows, the unsharded
    order (no partial-sum all-reduce), and the result is all-gathered over
    ``model`` onto x's placements (T_d * D).

The backward runs the mirror images (all-to-alls back, reduce-scatters of
the gathers whose use differed by rank, an all-reduce over ``model`` of x's
dispatch gradient).  ``moe_ffn_dense`` on a mesh: each rank routes its own
rows, runs its E_m experts on its data rank's T_d rows, and the (E_m, T_d,
D) outputs reach the rows' owners by one all-to-all over ``model`` (with
R = 1: an all-gather of (E, T_d, D)); then the one ``einsum`` over all E.
``routes`` counts the calls by route ("local", "expert_parallel").
"""

from __future__ import annotations

import collections
import math
from typing import List, Optional, Tuple

import torch
import torch.nn.functional as F
from torch.distributed.tensor import DTensor, Partial, Placement, Replicate, Shard

from repro_torch.train import sharding

# calls by route: "local" (plain tensors), "expert_parallel" (a mesh)
routes: collections.Counter = collections.Counter()


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
    if isinstance(x, DTensor):
        return _moe_ffn_mesh(x, router_w, w1, w3, w2, top_k, capacity_factor, mlp_kind)
    routes["local"] += 1
    t, d = x.shape
    e = router_w.shape[1]
    probs, gate_vals, expert_idx = _route(x, router_w, top_k)

    # Switch aux loss: E * sum_e f_e * p_e
    flat_expert = expert_idx.reshape(-1)                            # (T*K,)
    # counts by a fixed-size scatter (exact integers): every shape of the
    # dispatch is known before its data, as a fake-tensor trace needs
    counts = torch.zeros(e, dtype=torch.int64, device=x.device).scatter_add_(
        0, flat_expert, torch.ones_like(flat_expert))
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
    buf[dest] = x[st_tok]          # dropped pairs all land in the discarded last row
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
    if isinstance(x, DTensor):
        return _moe_ffn_dense_mesh(x, router_w, w1, w3, w2, top_k, mlp_kind)
    routes["local"] += 1
    t = x.shape[0]
    e = router_w.shape[1]
    _, gate_vals, expert_idx = _route(x, router_w, top_k)
    gates = torch.zeros(t, e, dtype=torch.float32, device=x.device)
    gates.scatter_(1, expert_idx, gate_vals)
    act = _act(torch.matmul(x, w1), mlp_kind) * torch.matmul(x, w3)  # (E, T, F)
    y_e = torch.matmul(act, w2)                                      # (E, T, D)
    return torch.einsum("etd,te->td", y_e, gates.to(x.dtype))


# -- expert parallelism on a mesh ---------------------------------------------

_c10d = torch.ops._c10d_functional


def _all_gather(t: torch.Tensor, group) -> torch.Tensor:
    """Every rank's t stacked on dim 0 in rank order (no gradient)."""
    out = _c10d.all_gather_into_tensor(t.contiguous(), group.size(), group.group_name)
    return _c10d.wait_tensor(out)


def _all_to_all(t: torch.Tensor, group) -> torch.Tensor:
    n = group.size()
    split = [t.shape[0] // n] * n
    out = _c10d.all_to_all_single(t.contiguous(), split, split, group.group_name)
    return _c10d.wait_tensor(out)


class _AllToAll(torch.autograd.Function):
    """Equal chunks of dim 0 exchanged over ``group`` (chunk r to rank r);
    the gradient goes back the same way."""

    @staticmethod
    def forward(ctx, t, group):
        ctx.group = group
        return _all_to_all(t, group)

    @staticmethod
    def backward(ctx, grad):
        return _all_to_all(grad, ctx.group), None


class _AllGather(torch.autograd.Function):
    """Every rank's t stacked on dim 0 in rank order.  Each rank reads its
    own part of the result, so a rank's gradient sums every rank's: a
    reduce-scatter."""

    @staticmethod
    def forward(ctx, t, group):
        ctx.group = group
        return _all_gather(t, group)

    @staticmethod
    def backward(ctx, grad):
        group = ctx.group
        out = _c10d.reduce_scatter_tensor(grad.contiguous(), "sum", group.size(),
                                          group.group_name)
        return _c10d.wait_tensor(out), None


class _Plan:
    """How one call splits over x's mesh (see the module's doc): P data
    ranks of T_d rows (this one d), M expert groups of E_m (this one m), R
    row groups over ``model`` for routing and the combine."""

    def __init__(self, x: DTensor, e: int):
        mesh = self.mesh = x.device_mesh
        names, sizes = sharding.axis_names(mesh), tuple(mesh.shape)
        coord = mesh.get_coordinate()
        self.data_dims = [names.index(a) for a in sharding.data_axes(mesh)]
        tp = sharding.tp_axis(mesh)
        self.model_dim = names.index(tp) if tp is not None else None
        t = x.shape[0]
        p = math.prod(sizes[i] for i in self.data_dims)
        self.P = p if p > 1 and t % p == 0 else 1
        self.d = 0
        if self.P > 1:
            for i in self.data_dims:
                self.d = self.d * sizes[i] + coord[i]
        m = sizes[self.model_dim] if self.model_dim is not None else 1
        self.M = m if m > 1 and e % m == 0 else 1
        self.m = coord[self.model_dim] if self.M > 1 else 0
        self.t_d = t // self.P
        self.R = self.M if self.M > 1 and self.t_d % self.M == 0 else 1

    def pl(self, data: Optional[Placement] = None,
           model: Optional[Placement] = None) -> List[Placement]:
        """One placement per mesh dim: ``data`` on the data dims when the
        rows are split over them, ``model`` on the model dim when the
        experts are, Replicate elsewhere."""
        out: List[Placement] = [Replicate()] * self.mesh.ndim
        if data is not None and self.P > 1:
            for i in self.data_dims:
                out[i] = data
        if model is not None and self.M > 1:
            out[self.model_dim] = model
        return out

    def rows(self) -> List[Placement]:
        """The placements of the rows this rank routes and combines."""
        return self.pl(Shard(0), Shard(0) if self.R > 1 else None)

    def data_group(self):
        """The process group of the data axes (flattened when several)."""
        if len(self.data_dims) == 1:
            return self.mesh.get_group(self.data_dims[0])
        return self.mesh[sharding.data_axes(self.mesh)]._flatten().get_group()

    def model_group(self):
        return self.mesh.get_group(self.model_dim)

    def local(self, t, placements: List[Placement],
              grads: Optional[List[Placement]] = None) -> torch.Tensor:
        """t (a DTensor on this mesh, or a plain tensor taken as
        replicated) on ``placements``, as this rank's local tensor whose
        gradient is declared as ``grads`` (default: ``placements``)."""
        if not isinstance(t, DTensor):
            t = DTensor.from_local(t, self.mesh, [Replicate()] * self.mesh.ndim,
                                   run_check=False)
        return t.redistribute(self.mesh, placements).to_local(grad_placements=grads)

    def weights(self, *ws) -> List[torch.Tensor]:
        """This rank's E_m experts, whole in D (gathered over the data axes
        only); their gradients partial sums over the data ranks that split
        the capacity rows."""
        return [self.local(w, self.pl(None, Shard(0)), self.pl(Partial(), Shard(0)))
                for w in ws]

    def out(self, y: torch.Tensor, x: DTensor) -> DTensor:
        """The local rows y back as a DTensor on x's placements (a partial
        sum of x's stays replicated: it can be reduced but not made)."""
        y = DTensor.from_local(y, self.mesh, self.rows(), run_check=False)
        return y.redistribute(self.mesh, [Replicate() if p.is_partial() else p
                                          for p in x.placements])


def _routed(plan: _Plan, xs: DTensor, router_w, top_k: int):
    """(probs (T_d / R, E), gates and experts (T_d / R, K)) of this rank's
    rows, and the experts of its data rank's T_d rows (T_d, K)."""
    x_r = xs.redistribute(plan.mesh, plan.rows()).to_local()
    # each rank routes its own rows: the router's gradient sums the ranks'
    router = plan.local(router_w, plan.pl(),
                        plan.pl(Partial(), Partial() if plan.R > 1 else None))
    probs, gate_vals, expert_idx = _route(x_r, router, top_k)
    experts = expert_idx
    if plan.R > 1:
        experts = _all_gather(expert_idx, plan.model_group())
    return probs, gate_vals, expert_idx, experts


def _moe_ffn_mesh(x: DTensor, router_w, w1, w3, w2, top_k: int, capacity_factor: float,
                  mlp_kind: str):
    routes["expert_parallel"] += 1
    t, d = x.shape
    e = router_w.shape[1]
    plan = _Plan(x, e)
    mesh, P, M, R, t_d = plan.mesh, plan.P, plan.M, plan.R, plan.t_d
    xs = x.redistribute(mesh, plan.pl(Shard(0)))
    probs, gate_vals, _, experts = _routed(plan, xs, router_w, top_k)

    # global counts: each data rank's, all-gathered (P, E)
    flat_expert = experts.reshape(-1)                               # (T_d*K,)
    counts = torch.zeros(e, dtype=torch.int64, device=probs.device).scatter_add_(
        0, flat_expert, torch.ones_like(flat_expert))
    every = counts[None]
    if P > 1:
        every = _all_gather(every, plan.data_group())
    total = every.sum(0)

    # the aux loss from the global mean of probs (one mean per routing rank)
    means = probs.mean(dim=0, keepdim=True)
    if P * R > 1:
        means = DTensor.from_local(means, mesh, plan.rows(), run_check=False)
        means = means.redistribute(mesh, plan.pl()).to_local()
    aux = e * torch.sum(means.mean(dim=0) * (total.float() / (t * top_k)))
    aux = DTensor.from_local(aux, mesh, plan.pl(), run_check=False)

    # positions in the global (token, slot) order: lower data ranks first
    capacity = max(int(t * top_k * capacity_factor / e), top_k)
    cap_p = -(-capacity // P)
    e_m = e // M
    first = plan.m * e_m
    flat_token = torch.arange(t_d, device=probs.device).repeat_interleave(top_k)
    order = torch.argsort(flat_expert, stable=True)
    se, st_tok = flat_expert[order], flat_token[order]
    starts = torch.cumsum(counts, 0) - counts                       # (E,)
    below = every[:plan.d].sum(0)                                   # lower data ranks'
    pos = torch.arange(t_d * top_k, device=probs.device) - starts[se] + below[se]
    keep = pos < capacity
    mine = keep & (se >= first) & (se < first + e_m)
    block = e_m * cap_p
    dest = torch.where(mine, (pos // cap_p) * block + (se - first) * cap_p + pos % cap_p,
                       torch.full_like(se, P * block))

    # dispatch: this rank's pairs of expert group m, one block per data rank
    x_d = xs.to_local(grad_placements=plan.pl(Shard(0), Partial()))
    send = torch.zeros(P * block + 1, d, dtype=x.dtype, device=x_d.device)
    send[dest] = x_d[st_tok]       # other groups' and dropped pairs: the discarded row
    buf = send[:-1]
    if P > 1:
        recv = _AllToAll.apply(buf, plan.data_group()).view(P, block, d)
        # the data rank whose pairs own each slot of this rank's block
        slot = plan.d * cap_p + torch.arange(cap_p, device=recv.device)
        lo = (torch.cumsum(every, 0) - every)[:, first:first + e_m]  # (P, E_m)
        owner = (lo[:, :, None] <= slot[None, None, :]).sum(0) - 1   # (E_m, C_p)
        buf = recv[owner.reshape(-1), torch.arange(block, device=recv.device)]
    buf = buf.view(e_m, cap_p, d)
    w1_l, w3_l, w2_l = plan.weights(w1, w3, w2)
    act = _act(torch.bmm(buf, w1_l), mlp_kind) * torch.bmm(buf, w3_l)
    out_buf = torch.bmm(act, w2_l).view(block, d)
    if P > 1:
        out_buf = _AllGather.apply(out_buf, plan.data_group())     # (P * block, D)
    out_buf = torch.cat([out_buf, out_buf.new_zeros(1, d)])

    vals = out_buf[dest]                                            # sorted order
    slots = torch.empty_like(vals)
    slots[order] = vals                                             # token-major
    slots = slots.view(t_d, top_k, d)
    kept = torch.empty_like(keep)
    kept[order] = keep
    kept = kept.view(t_d, top_k)
    if M > 1:
        # each slot's output from the rank of its expert's group
        t_r = t_d // R
        if R > 1:
            got = _AllToAll.apply(slots, plan.model_group()).view(M, t_r, top_k, d)
            rows = slice(plan.m * t_r, (plan.m + 1) * t_r)
        else:
            got = DTensor.from_local(slots[None], mesh, plan.pl(Shard(1), Shard(0)),
                                     run_check=False)
            got = got.redistribute(mesh, plan.pl(Shard(1))).to_local()
            rows = slice(0, t_d)
        owner = experts[rows] // e_m
        slots = got[owner, torch.arange(t_r, device=got.device)[:, None],
                    torch.arange(top_k, device=got.device)[None, :]]
        kept = kept[rows]
    per_slot = slots * (gate_vals * kept)[..., None].to(x.dtype)
    y = per_slot[:, 0]
    for j in range(1, top_k):
        y = y + per_slot[:, j]
    return plan.out(y, x), aux


def _moe_ffn_dense_mesh(x: DTensor, router_w, w1, w3, w2, top_k: int, mlp_kind: str):
    routes["expert_parallel"] += 1
    e = router_w.shape[1]
    plan = _Plan(x, e)
    mesh, M, R, t_d = plan.mesh, plan.M, plan.R, plan.t_d
    xs = x.redistribute(mesh, plan.pl(Shard(0)))
    _, gate_vals, expert_idx, _ = _routed(plan, xs, router_w, top_k)
    gates = torch.zeros(gate_vals.shape[0], e, dtype=torch.float32, device=gate_vals.device)
    gates.scatter_(1, expert_idx, gate_vals)
    x_e = xs.to_local(grad_placements=plan.pl(Shard(0), Partial()))
    w1_l, w3_l, w2_l = plan.weights(w1, w3, w2)
    act = _act(torch.matmul(x_e, w1_l), mlp_kind) * torch.matmul(x_e, w3_l)  # (E_m, T_d, F)
    y_e = torch.matmul(act, w2_l)                                            # (E_m, T_d, D)
    if R > 1:
        # rank m' sends rank m its experts' outputs on m's rows
        got = _AllToAll.apply(y_e.transpose(0, 1), plan.model_group())      # (T_d, E_m, D)
        y_e = got.view(M, t_d // R, e // M, -1).permute(0, 2, 1, 3).reshape(e, t_d // R, -1)
    elif M > 1:
        y_e = DTensor.from_local(y_e, mesh, plan.pl(Shard(1), Shard(0)), run_check=False)
        y_e = y_e.redistribute(mesh, plan.pl(Shard(1))).to_local()          # (E, T_d, D)
    return plan.out(torch.einsum("etd,te->td", y_e, gates.to(x.dtype)), x)
