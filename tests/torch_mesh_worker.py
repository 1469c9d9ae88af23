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


# decode_attention's placements on a mesh: (q, cache) per mesh dim, as
# (data, model); the second is cache_pspecs' (batch on data, slots on model)
DECODE_PLACEMENTS = {
    "batch_heads": (("S0", "S1"), ("S0", "S1")),
    "batch_slots": (("S0", "S1"), ("S0", "S2")),
    "replicated_q": (("R", "R"), ("S0", "S2")),
    "heads_slots": (("R", "S1"), ("S1", "S2")),
}
DECODE_ARCHS = ("internlm2-1.8b", "olmoe-1b-7b", "hymba-1.5b")
DECODE_STEPS = 4
PROMPT, CACHE_LEN = 20, 16      # a prompt longer than the cache: the ring's roll


def decode(rank, world, store_path, shape, out_dir):
    """``layers.decode_attention`` on DTensors of each placement of
    ``DECODE_PLACEMENTS``, and a ``Model.prefill`` of PROMPT tokens into a
    CACHE_LEN cache then DECODE_STEPS ``decode_step`` s of each
    ``DECODE_ARCHS`` reduced config, sharded on a gloo (data, model) mesh;
    rank 0 writes the whole outputs and the logits (``decode.npz``)."""
    import torch
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh
    from torch.distributed.tensor import Replicate, Shard, distribute_tensor

    from repro_torch.models import Model
    from repro_torch.models.layers import decode_attention
    from repro_torch.train.sharding import shard_model

    torch.set_num_threads(1)
    dist.init_process_group("gloo", store=dist.FileStore(store_path, world),
                            rank=rank, world_size=world)
    try:
        mesh = init_device_mesh("cpu", shape, mesh_dim_names=("data", "model"))
        out = {}
        q, k, v, pos = (torch.from_numpy(a) for a in decode_inputs())
        pl = lambda names: [Replicate() if n == "R" else Shard(int(n[1])) for n in names]
        for name, (q_pl, c_pl) in DECODE_PLACEMENTS.items():
            for window in (0, 5):
                o = decode_attention(distribute_tensor(q, mesh, pl(q_pl)),
                                     distribute_tensor(k, mesh, pl(c_pl)),
                                     distribute_tensor(v, mesh, pl(c_pl)),
                                     pos=pos, window=window)
                out[f"attn/{name}/{window}"] = full(o)
        for arch in DECODE_ARCHS:
            model = Model(reduced(arch), device="cpu").init(torch.Generator().manual_seed(0))
            shard_model(model, mesh)
            prompt, steps = decode_tokens(model.cfg)
            lg, cache = model.prefill({"tokens": torch.from_numpy(prompt)}, cache_len=CACHE_LEN)
            out[f"prefill/{arch}"] = full(lg)
            for t, tok in enumerate(steps):
                lg, cache = model.decode_step(cache, torch.from_numpy(tok))
                out[f"logits/{arch}/{t}"] = full(lg)
        if rank == 0:
            np.savez(os.path.join(out_dir, "decode.npz"), **out)
    finally:
        dist.destroy_process_group()


def decode_inputs():
    """(q (4, 8, 16), caches (4, 4, 12, 16), pos (4,)) f32 / int32 numpy."""
    rng = np.random.default_rng(3)
    q = rng.standard_normal((4, 8, 16)).astype(np.float32)
    k = rng.standard_normal((4, 4, 12, 16)).astype(np.float32)
    v = rng.standard_normal((4, 4, 12, 16)).astype(np.float32)
    return q, k, v, np.array([0, 4, 7, 11], np.int32)


def decode_tokens(cfg):
    """(a (4, PROMPT) prompt, DECODE_STEPS (4,) tokens), int32."""
    rng = np.random.default_rng(9)
    prompt = rng.integers(0, cfg.vocab_size, (4, PROMPT)).astype(np.int32)
    return prompt, [rng.integers(0, cfg.vocab_size, 4).astype(np.int32)
                    for _ in range(DECODE_STEPS)]
