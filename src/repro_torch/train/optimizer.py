"""AdamW of the port: the reference's ``train/optimizer.py``, leaf by leaf.

Moments are kept in float32 whatever the parameter dtype (bf16-safe).  The
arithmetic is the reference's, in its order and in f32 tensors: the
schedule on the step as an f32 scalar, the bias corrections
``1 - b ** step``, clipping by the f32 global norm, and per leaf
``p - lr (mh / (sqrt(vh) + eps) + wd p)`` with ``mh = m / (1 - b1^t)`` and
``vh = v / (1 - b2^t)`` (``torch.optim.AdamW`` divides ``sqrt(v)`` by
``sqrt(1 - b2^t)`` instead, which rounds otherwise).  Weight decay applies
to every leaf, norms included, as the reference applies it.  No step
synchronises with the host: the norm, the clip and the schedule stay on the
device.  Unlike the reference's pure update, :func:`adamw_update` writes the
parameters and both moments in place (each op rounds as the reference's
does), so a full-width step holds one copy of the 3 x 4 bytes per parameter
the moments and their update need, not two.

DTensor parameters (a device mesh) take the same code: the moments mirror
each parameter's placements (the reference's ``_state_shardings``), the step
is a replicated 0-d DTensor, each gradient is first placed as its parameter
(a reduce-scatter or all-reduce of a partial sum), the global norm reduces
every leaf's sum of squares over the whole mesh, and the in-place update
writes each rank's local shards.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Dict, NamedTuple, Tuple

import torch
from torch.distributed.tensor import DTensor, Replicate

from repro_torch.models.layers import like

Tree = Dict[str, torch.Tensor]


@dataclasses.dataclass(frozen=True)
class AdamWConfig:
    lr: float = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    grad_clip: float = 1.0
    warmup_steps: int = 100
    total_steps: int = 10_000
    min_lr_ratio: float = 0.1


class OptState(NamedTuple):
    step: torch.Tensor   # () int32
    mu: Tree             # f32, one per parameter
    nu: Tree


def init_opt_state(params: Tree) -> OptState:
    f32 = lambda p: torch.zeros_like(p, dtype=torch.float32)
    first = next(iter(params.values()))
    step = like(torch.zeros((), dtype=torch.int32, device=first.device), first)
    return OptState(step=step, mu={n: f32(p) for n, p in params.items()},
                    nu={n: f32(p) for n, p in params.items()})


def lr_schedule(cfg: AdamWConfig, step: torch.Tensor) -> torch.Tensor:
    """Linear warmup to ``cfg.lr``, then cosine decay to ``min_lr_ratio``
    of it at ``total_steps``; f32 on the step's device."""
    step = step.to(torch.float32)
    warm = torch.clamp(step / max(cfg.warmup_steps, 1), max=1.0)
    frac = torch.clamp((step - cfg.warmup_steps)
                       / max(cfg.total_steps - cfg.warmup_steps, 1), 0.0, 1.0)
    cos = 0.5 * (1.0 + torch.cos(math.pi * frac))
    return cfg.lr * warm * (cfg.min_lr_ratio + (1 - cfg.min_lr_ratio) * cos)


def replicated(t: torch.Tensor) -> torch.Tensor:
    """A DTensor reduced or gathered onto every rank; a plain tensor as it is."""
    if not isinstance(t, DTensor):
        return t
    return t.redistribute(t.device_mesh, [Replicate()] * t.device_mesh.ndim)


def global_norm(tree: Tree) -> torch.Tensor:
    """sqrt of the sum over leaves of each leaf's f32 sum of squares (each
    DTensor leaf's summed over the whole mesh)."""
    sums = [replicated(torch.sum(torch.square(g.float()))) for g in tree.values()]
    return torch.sqrt(torch.sum(torch.stack(sums)))


@torch.no_grad()
def adamw_update(cfg: AdamWConfig, params: Tree, grads: Tree,
                 state: OptState) -> Tuple[Tree, OptState, Dict[str, torch.Tensor]]:
    """Returns (params, new state, metrics {grad_norm, lr}): ``params`` and
    the moments of ``state`` are updated in place and returned."""
    grads = {n: g.redistribute(params[n].device_mesh, params[n].placements)
             if isinstance(g, DTensor) else g for n, g in grads.items()}
    gnorm = global_norm(grads)
    clip = torch.clamp(cfg.grad_clip / torch.clamp(gnorm, min=1e-9), max=1.0)
    step = state.step + 1
    lr = lr_schedule(cfg, step)
    stepf = step.to(torch.float32)
    b1c = 1.0 - torch.pow(cfg.b1, stepf)
    b2c = 1.0 - torch.pow(cfg.b2, stepf)
    for n, p in params.items():
        g = grads[n].float() * clip
        m = state.mu[n].mul_(cfg.b1).add_((1 - cfg.b1) * g)
        v = state.nu[n].mul_(cfg.b2).add_((1 - cfg.b2) * g * g)
        del g
        delta = (m / b1c).div_(torch.sqrt(v / b2c).add_(cfg.eps))
        delta.add_(cfg.weight_decay * p.float())
        p.copy_(p.float().sub_(lr * delta))
    return params, OptState(step, state.mu, state.nu), {"grad_norm": gnorm, "lr": lr}
