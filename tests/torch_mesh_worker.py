"""One rank of a CPU gloo group for ``tests/test_torch_mesh_train.py``:
reduced configs' sharded training steps on a (data, model) device mesh,
a checkpoint of the sharded state, and an elastic restore of another
group's checkpoint.  Rank 0 writes what the test reads (``.npz`` of the
losses and the full parameters) into the job's directory.

Spawned (``multiprocessing`` spawn context) by the test; every rank builds
the same seeded weights and batches, and ``sharding.shard_model`` keeps each
rank's shard of them.
"""

from __future__ import annotations

import os

import numpy as np

# the last is internlm2 with one kv head: on a mesh whose axes do not
# divide the kv heads each q head gets its own (layers.mea_attention)
ARCHS = ("internlm2-1.8b", "hymba-1.5b", "olmoe-1b-7b", "internlm2-1.8b/mqa")
BATCH, SEQ, STEPS = 4, 32, 2
# eps 1e-3 as the train tests compare parameters: at 1e-8 a near-zero
# gradient element moves by up to lr whatever its rounding
OPT = dict(lr=3e-3, eps=1e-3, warmup_steps=1, total_steps=4)


def reduced(arch):
    """The arch's reduced config (f32); ``<arch>/mqa`` with one kv head."""
    from repro_torch.configs import get_config

    name, _, variant = arch.partition("/")
    return get_config(name).reduced(**({"num_kv_heads": 1} if variant == "mqa" else {}))


def batches(cfg, seed=5):
    """STEPS global batches of (tokens, labels), int32 numpy."""
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(STEPS):
        t = rng.integers(0, cfg.vocab_size, (BATCH, SEQ + 1), dtype=np.int32)
        out.append({"tokens": t[:, :-1], "labels": t[:, 1:]})
    return out


def train(cfg, mesh=None):
    """(model, state, losses) after STEPS steps from seed 0, sharded on
    ``mesh`` when one is given."""
    import torch

    from repro_torch.models import Model
    from repro_torch.train import sharding
    from repro_torch.train.optimizer import AdamWConfig, init_opt_state
    from repro_torch.train.step import TrainState, make_train_step

    model = Model(cfg, device="cpu").init(torch.Generator().manual_seed(0))
    model.requires_grad_(True)
    if mesh is not None:
        sharding.shard_model(model, mesh)
    params = dict(model.named_parameters())
    state = TrainState(params, init_opt_state(params), None)
    fn = make_train_step(model, AdamWConfig(**OPT))
    losses = []
    for b in batches(cfg):
        state, m = fn(state, {k: torch.from_numpy(v) for k, v in b.items()})
        loss = m["loss"]
        losses.append(float(loss.full_tensor() if hasattr(loss, "full_tensor") else loss))
    return model, state, losses


def full(t):
    return (t.full_tensor() if hasattr(t, "full_tensor") else t).detach().numpy()


def run(rank, world, store_path, shape, out_dir, restore_from=None, archs=ARCHS):
    import torch
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh

    torch.set_num_threads(1)
    dist.init_process_group("gloo", store=dist.FileStore(store_path, world),
                            rank=rank, world_size=world)
    try:
        from repro_torch.models import Model
        from repro_torch.train import checkpoint
        from repro_torch.train.optimizer import init_opt_state
        from repro_torch.train.sharding import shard_model
        from repro_torch.train.step import TrainState, state_shardings

        mesh = init_device_mesh("cpu", shape, mesh_dim_names=("data", "model"))
        tag = "x".join(map(str, shape))
        for arch in archs:
            cfg = reduced(arch)
            model, state, losses = train(cfg, mesh)
            arrays = {f"param/{n}": full(p) for n, p in state.params.items()}
            if arch == ARCHS[0]:
                checkpoint.save(os.path.join(out_dir, f"ckpt_{tag}"), STEPS, state)
            if rank == 0:
                np.savez(os.path.join(out_dir, f"{tag}_{arch.replace('/', '_')}.npz"),
                         losses=np.array(losses), **arrays)
        if restore_from is not None:
            # the first arch's checkpoint of another mesh, restored onto this one
            cfg = reduced(ARCHS[0])
            model = Model(cfg, device="cpu")
            shard_model(model, mesh)
            params = dict(model.named_parameters())
            target = TrainState(params, init_opt_state(params), None)
            checkpoint.restore(restore_from, STEPS, target, shardings=state_shardings(model, mesh))
            arrays = {f"param/{n}": full(p) for n, p in target.params.items()}
            arrays.update({f"mu/{n}": full(m) for n, m in target.opt.mu.items()})
            arrays["step"] = full(target.opt.step)
            if rank == 0:
                np.savez(os.path.join(out_dir, f"restored_{tag}.npz"), **arrays)
    finally:
        dist.destroy_process_group()


def trace_step(rank, world, store_path, shape, out_path, arch, seq, batch):
    """A real training step of ``arch``'s reduced config on a gloo (data,
    model) mesh, under ``TraceAnalysis``: rank 0 writes the collective
    counts (the dry run's fake trace of the same cell must count the same)."""
    import json

    import torch
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh

    from repro_torch.launch import dryrun
    from repro_torch.launch.specs import ShapeSpec
    from repro_torch.launch.trace_analysis import TraceAnalysis

    torch.set_num_threads(1)
    dist.init_process_group("gloo", store=dist.FileStore(store_path, world),
                            rank=rank, world_size=world)
    try:
        mesh = init_device_mesh("cpu", shape, mesh_dim_names=("data", "model"))
        cell = ShapeSpec("cell", "train", seq, batch)
        fn, args, _ = dryrun.build_cell(reduced(arch), cell, mesh, "baseline", "cpu")
        with TraceAnalysis(mesh.size()) as trace:
            fn(*args)
        if rank == 0:
            with open(out_path, "w") as f:
                json.dump(trace.result(), f)
    finally:
        dist.destroy_process_group()
