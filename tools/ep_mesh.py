#!/usr/bin/env python3
"""The MoE FFN expert-parallel across several cards: olmoe-1b-7b at full
width (64 experts top-8, d 2048, dff 1024) cut to 2 layers, f32, trained
on real (data, model) meshes of 4 ranks, against the one-card step.

    python3 tools/ep_mesh.py                    # 4 CUDA cards, NCCL
    python3 tools/ep_mesh.py --device cpu --reduced --seq 32   # a gloo rehearsal

Builds the kernels first (CUDA), then spawns one process a rank (a
``tcp://localhost`` group of ``--world`` ranks).  For each mesh of
``--meshes`` every rank runs the unsharded steps on its own card (the same
weights, batches and microbatches as the mesh: ``dryrun.microbatches``),
then the same steps with the state sharded by ``train/sharding.py`` and
the dry run's hints, its MoE FFN expert-parallel (``moe.routes`` counts
only that route).  The first step is held to the one-card step within
rtol 1e-5: each parameter's gradient, the loss, the gradient norm and
every ``full_tensor()`` parameter after it (and 1e-5 of the leaf's
largest magnitude near zero), as ``tests/test_torch_mesh_train.py`` holds
its steps on gloo; f32, so that rtol 1e-5 can hold where partial sums add
in another order.  The later steps' losses are printed beside the
one-card ones with their relative gaps.  Rank 0 prints each mesh's
gradient errors by leaf and one line of its results (losses, step walls,
peak memory), one JSON line of everything, then the card's name and power
limit.  Exits non-zero on any failed check.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import socket
import statistics
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(ROOT, "src"))

STEPS = 3


def first_grads(model, batch, mbs, full):
    """Each parameter's gradient of the first step's loss (the train step's:
    the microbatches' mean), whole, on the host."""
    import torch

    from repro_torch.train import sharding
    from repro_torch.train.step import cross_entropy, microbatch

    if hasattr(model.embed, "device_mesh"):
        batch = sharding.place_batch(batch, model.embed.device_mesh)
    params = dict(model.named_parameters())
    total = None
    for m in range(mbs):
        mb = {k: microbatch(v, m, mbs) for k, v in batch.items()}
        logits, aux = model(mb)
        loss = cross_entropy(logits, mb["labels"], model.cfg.vocab_size) + 0.01 * aux
        grads = torch.autograd.grad(loss, list(params.values()), materialize_grads=True)
        total = grads if total is None else [a + b for a, b in zip(total, grads)]
    return {n: (full(g) / mbs).detach().float().cpu().numpy().copy()
            for n, g in zip(params, total)}


def free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def rank_main(rank, args, port, out):
    import numpy as np
    import torch
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh

    from repro_torch.configs import get_config
    from repro_torch.launch import dryrun
    from repro_torch.launch.specs import ShapeSpec
    from repro_torch.models import Model, moe
    from repro_torch.train import sharding
    from repro_torch.train.data import TokenPipeline
    from repro_torch.train.optimizer import AdamWConfig, init_opt_state
    from repro_torch.train.step import TrainState, init_train_state, make_train_step

    cuda = args.device == "cuda"
    if cuda:
        torch.cuda.set_device(rank)
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
    else:
        torch.set_num_threads(1)
    dist.init_process_group("nccl" if cuda else "gloo", init_method=f"tcp://localhost:{port}",
                            rank=rank, world_size=args.world)
    dev = torch.device("cuda", rank) if cuda else torch.device("cpu")
    sync = torch.cuda.synchronize if cuda else (lambda: None)
    try:
        cfg = get_config(args.arch)
        cfg = cfg.reduced() if args.reduced else dataclasses.replace(cfg, num_layers=2)
        cfg = dataclasses.replace(cfg, dtype="float32")
        shape = ShapeSpec("ep", "train", args.seq, args.batch)
        pipe = TokenPipeline(cfg.vocab_size, args.batch, args.seq, seed=31)
        batches = [{k: torch.from_numpy(v).to(dev) for k, v in pipe.next_batch().items()}
                   for _ in range(STEPS)]
        opt = AdamWConfig(lr=3e-4, eps=1e-3, warmup_steps=1, total_steps=STEPS,
                          weight_decay=0.0)
        full = lambda t: t.full_tensor() if hasattr(t, "full_tensor") else t
        results = {}
        for mesh_shape in args.meshes:
            mesh = init_device_mesh(args.device, mesh_shape, mesh_dim_names=("data", "model"))
            mbs = dryrun.microbatches(shape, mesh)
            runs = {}
            for sharded in (False, True):
                if cuda:
                    torch.cuda.empty_cache()
                    torch.cuda.reset_peak_memory_stats()
                model = Model(cfg, device=dev)
                gen = torch.Generator(device=dev).manual_seed(5)
                state = init_train_state(model, gen)
                if sharded:
                    sharding.shard_model(model, mesh)
                    model.shard_hints = dryrun.shard_hints(cfg, shape, mesh, "baseline")
                    params = dict(model.named_parameters())
                    state = TrainState(params, init_opt_state(params), None)
                grads = first_grads(model, batches[0], mbs, full)
                fn = make_train_step(model, opt, microbatches=mbs)
                moe.routes.clear()
                losses, norms, walls = [], [], []
                for i, b in enumerate(batches):
                    sync()
                    t0 = time.perf_counter()
                    state, m = fn(state, b)
                    losses.append(float(full(m["loss"])))
                    norms.append(float(full(m["grad_norm"])))
                    sync()
                    walls.append(time.perf_counter() - t0)
                    if i == 0:
                        # a copy: on the CPU .numpy() would alias the updated leaf
                        params = {n: full(p).detach().float().cpu().numpy().copy()
                                  for n, p in model.named_parameters()}
                runs[sharded] = {"losses": losses, "grad_norms": norms,
                                 "walls_ms": [w * 1e3 for w in walls],
                                 "routes": dict(moe.routes),
                                 "peak_gb": torch.cuda.max_memory_allocated() / 1e9 if cuda else None,
                                 "params": params, "grads": grads}
                del model, state, fn
            a, b = runs[False], runs[True]
            # each leaf's gradient error over (|g| + max|g|), printed before the checks
            gerr = {n: float((np.abs(b["grads"][n] - g) / (np.abs(g) + np.abs(g).max())).max())
                    for n, g in a["grads"].items()}
            if rank == 0:
                print(f"[ep] ({'x'.join(map(str, mesh_shape))}) step 1 gradient errors by "
                      f"leaf: {json.dumps(gerr)}", flush=True)
            for n, want in a["grads"].items():
                np.testing.assert_allclose(b["grads"][n], want, rtol=1e-5,
                                           atol=1e-5 * float(np.abs(want).max()), err_msg=n)
            np.testing.assert_allclose(b["losses"][0], a["losses"][0], rtol=1e-5)
            np.testing.assert_allclose(b["grad_norms"][0], a["grad_norms"][0], rtol=1e-5)
            worst = 0.0
            for n, want in a["params"].items():
                np.testing.assert_allclose(b["params"][n], want, rtol=1e-5,
                                           atol=1e-5 * float(np.abs(want).max()), err_msg=n)
                scale = np.abs(want) + float(np.abs(want).max())
                worst = max(worst, float((np.abs(b["params"][n] - want) / scale).max()))
            # the MoE calls of the steps (the first gradient's own run twice as many a layer)
            calls = cfg.num_layers * mbs * STEPS * (2 if cfg.remat else 1) if cfg.is_moe else 0
            assert b["routes"].get("expert_parallel", 0) == calls, b["routes"]
            assert a["routes"].get("local", 0) == calls, a["routes"]
            tag = "x".join(map(str, mesh_shape))
            gaps = [abs(x - y) / abs(y) for x, y in zip(b["losses"], a["losses"])]
            results[tag] = {"microbatches": mbs, "moe_calls": calls,
                            "max_param_rel_err_step1": worst, "loss_rel_gaps": gaps,
                            "grad_rel_err_step1": gerr,
                            **{("sharded" if s else "unsharded"):
                               {k: v for k, v in r.items() if k not in ("params", "grads")}
                               for s, r in runs.items()}}
            if rank == 0:
                print(f"[ep] {cfg.name} {'reduced' if args.reduced else 'full width'}, "
                      f"{cfg.num_layers} layers, f32, {args.batch} x {args.seq} tokens, {mbs} "
                      f"microbatches, ({tag}) mesh of {args.world} ranks: losses "
                      f"{b['losses']} against the one-card {a['losses']} (relative gaps "
                      f"{', '.join(f'{g:.2e}' for g in gaps)}); step 1's gradient norm "
                      f"{b['grad_norms'][0]} against {a['grad_norms'][0]}, parameters after "
                      f"it within {worst:.3e} of (|x| + max|x|); {calls} MoE calls on the "
                      f"expert-parallel route; step {statistics.median(b['walls_ms']):.2f} ms sharded, "
                      f"{statistics.median(a['walls_ms']):.2f} ms on one card (medians of "
                      f"{STEPS}); peak {b['peak_gb']} / {a['peak_gb']} GB", flush=True)
        if rank == 0:
            with open(out, "w") as f:
                json.dump(results, f)
    finally:
        dist.destroy_process_group()


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", choices=["cuda", "cpu"], default="cuda")
    ap.add_argument("--world", type=int, default=4)
    ap.add_argument("--meshes", default="2x2,1x4",
                    help="comma-separated (data x model) meshes of --world ranks")
    ap.add_argument("--arch", default="olmoe-1b-7b")
    ap.add_argument("--reduced", action="store_true", help="the arch's reduced config")
    ap.add_argument("--batch", type=int, default=2)
    ap.add_argument("--seq", type=int, default=4096)
    args = ap.parse_args()
    args.meshes = [tuple(int(x) for x in m.split("x")) for m in args.meshes.split(",")]
    import torch
    import torch.multiprocessing as mp

    if args.device == "cuda":
        if torch.cuda.device_count() < args.world:
            print(f"ep_mesh: {torch.cuda.device_count()} CUDA devices, {args.world} needed",
                  file=sys.stderr)
            return 2
        from repro_torch.kernels import _build
        t0 = time.perf_counter()
        _build.build()
        print(f"[build] {len(_build.KERNELS)} kernels in {time.perf_counter() - t0:.2f} s")
    out = os.path.join(ROOT, "build", "ep_mesh.json")
    os.makedirs(os.path.dirname(out), exist_ok=True)
    if os.path.exists(out):
        os.remove(out)
    mp.spawn(rank_main, args=(args, free_port(), out), nprocs=args.world, join=True)
    with open(out) as f:
        print(json.dumps(json.load(f)))
    if args.device == "cuda":
        print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True,
                             text=True).stdout.strip().splitlines()[0])
    return 0


if __name__ == "__main__":
    sys.exit(main())
