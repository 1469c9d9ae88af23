"""Loss and train-step factory of the port: the reference's
``train/step.py``.  The forward is rematerialised per block
(``Model.forward`` under ``cfg.remat``), microbatches accumulate f32
gradients, and an optional error-feedback gradient compression runs before
the optimizer.  There is no ``jit``: the step runs eagerly on the model's
device, through the flash and GLA kernels forward and backward on the card.

On a device mesh (the model's parameters DTensors, ``sharding.shard_model``)
the same code runs on DTensors: the moments mirror the parameters'
placements leaf for leaf (``optimizer.init_opt_state``), a plain batch is
placed by ``sharding.place_batch`` (each rank keeps its rows of the same
global batch), and a microbatch of a batch-sharded leaf is cut from each
rank's own rows when they divide evenly, as the strided split then allows.
"""

from __future__ import annotations

from typing import Dict, NamedTuple, Optional

import torch
from torch.distributed.tensor import DTensor, Replicate, Shard

from repro_torch.models import Model
from repro_torch.models.layers import like
from repro_torch.train import compression, sharding
from repro_torch.train.optimizer import (AdamWConfig, OptState, adamw_update, init_opt_state,
                                         replicated)

Tree = Dict[str, torch.Tensor]


class TrainState(NamedTuple):
    params: Tree               # the model's own parameters, by state-dict name
    opt: OptState
    residual: Optional[Tree]   # error-feedback buffer (None when compression is off)


def cross_entropy(logits: torch.Tensor, labels: torch.Tensor, vocab_size: int) -> torch.Tensor:
    """Mean token cross entropy over the padded vocabulary, in f32: the
    padding columns masked to -1e30, the row max detached (the reference's
    ``stop_gradient``), the label's logit picked by index."""
    logits = logits.float()
    vpad = logits.shape[-1]
    if vpad > vocab_size:
        keep = torch.arange(vpad, device=logits.device) < vocab_size
        logits = torch.where(like(keep, logits), logits, -1e30)
    m = logits.amax(dim=-1, keepdim=True).detach()
    total = torch.sum(torch.exp(logits - m), dim=-1)
    if isinstance(total, DTensor):
        # a vocab-sharded sum is a partial sum: reduce it before the log
        # (torch 2.11's DTensor, left to reduce it inside the log, gives a
        # wrong gradient when another mesh dim shards the rows)
        total = total.redistribute(total.device_mesh, [Replicate() if p.is_partial() else p
                                                       for p in total.placements])
    lse = torch.log(total) + m[..., 0]
    if isinstance(logits, DTensor):
        # on a mesh, the label's logit by a select and a sum over the
        # (vocab-sharded) last dim: elementwise on each shard, forward and
        # backward, then one small reduction; the same value as the gather
        ids = like(torch.arange(vpad, device=logits.device), logits)
        hit = ids == labels.long()[..., None]
        label_logit = torch.sum(torch.where(hit, logits, 0.0), dim=-1)
    else:
        label_logit = logits.gather(-1, labels.long()[..., None])[..., 0]
    return (lse - label_logit).mean()


def init_train_state(model: Model, generator: torch.Generator, *,
                     compress: bool = False) -> TrainState:
    """Random weights from ``generator`` (``Model.init``), gradients switched
    on, zero moments, and a zero f32 residual when ``compress``."""
    model.init(generator)
    model.requires_grad_(True)
    params = dict(model.named_parameters())
    residual = ({n: torch.zeros_like(p, dtype=torch.float32) for n, p in params.items()}
                if compress else None)
    return TrainState(params=params, opt=init_opt_state(params), residual=residual)


def microbatch(v: torch.Tensor, m: int, n: int) -> torch.Tensor:
    """Rows m, m + n, ... of v.  A DTensor whose rows are sharded evenly in
    blocks that n divides gives them from each rank's own rows (the global
    rows are the ranks' local ones in order); any other takes DTensor's
    strided slice."""
    if isinstance(v, DTensor) and all(p == Shard(0) or p == Replicate() for p in v.placements):
        local = v.to_local()
        shards = 1
        for size, p in zip(v.device_mesh.shape, v.placements):
            shards *= size if p == Shard(0) else 1
        if local.shape[0] % n == 0 and local.shape[0] * shards == v.shape[0]:
            return DTensor.from_local(local[m::n], v.device_mesh, v.placements, run_check=False)
    return v[m::n]


def state_shardings(model: Model, mesh, *, compress: bool = False) -> TrainState:
    """Where a ``TrainState`` of ``model`` lives on ``mesh``: a
    ``sharding.Placed`` per leaf, the parameters by
    ``sharding.params_shardings``, the moments (and the residual) mirroring
    them leaf for leaf, the step replicated (the reference's
    ``_state_shardings``)."""
    params = {n: sharding.Placed(mesh, tuple(p))
              for n, p in sharding.params_shardings(model, mesh).items()}
    step = sharding.Placed(mesh, (Replicate(),) * mesh.ndim)
    return TrainState(params, OptState(step, dict(params), dict(params)),
                      dict(params) if compress else None)


def make_train_step(model: Model, opt_cfg: AdamWConfig, *, microbatches: int = 1,
                    aux_weight: float = 0.01, compress: bool = False):
    """Builds ``train_step(state, batch) -> (state, metrics)`` over
    ``batch = {"tokens", "labels"}`` (B, S) on the model's device;
    ``state.params`` must be ``model``'s parameters.  The parameters and
    moments are updated in place (``optimizer.adamw_update``).

    microbatches > 1 splits the batch on axis 0, strided as the reference
    splits it (microbatch m takes rows m, m + n, ...), and sums the
    gradients in f32 before scaling by 1 / n: one optimizer step per global
    batch.  metrics: ``loss``, ``grad_norm``, ``lr``, ``compression_err``,
    all 0-d tensors on the device (replicated DTensors on a mesh).
    """
    vocab = model.cfg.vocab_size

    def loss_fn(batch):
        logits, aux = model(batch)
        return cross_entropy(logits, batch["labels"], vocab) + aux_weight * aux

    def value_and_grad(params: Tree, batch):
        loss = loss_fn(batch)
        grads = torch.autograd.grad(loss, list(params.values()), materialize_grads=True)
        return loss.detach(), dict(zip(params, grads))

    def compute_grads(params: Tree, batch):
        if microbatches == 1:
            return value_and_grad(params, batch)
        loss_sum = None
        g_sum = {n: torch.zeros_like(p, dtype=torch.float32) for n, p in params.items()}
        for m in range(microbatches):
            loss, grads = value_and_grad(params, {k: microbatch(v, m, microbatches)
                                                  for k, v in batch.items()})
            for n in params:
                g_sum[n] = g_sum[n] + grads[n]
            loss_sum = loss.float() if loss_sum is None else loss_sum + loss
            del grads
        scale = 1.0 / microbatches
        return loss_sum * scale, {n: g * scale for n, g in g_sum.items()}

    def train_step(state: TrainState, batch):
        if isinstance(model.embed, DTensor):
            batch = sharding.place_batch(batch, model.embed.device_mesh)
        loss, grads = compute_grads(state.params, batch)
        residual = state.residual
        comp_err = like(torch.zeros((), dtype=torch.float32, device=loss.device), loss)
        if compress:
            grads, residual, comp_err = compression.compress_tree(grads, residual)
        params, opt, metrics = adamw_update(opt_cfg, state.params, grads, state.opt)
        metrics = dict(metrics, loss=replicated(loss), compression_err=comp_err)
        return TrainState(params, opt, residual), metrics

    return train_step
