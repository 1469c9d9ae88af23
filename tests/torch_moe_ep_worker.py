"""One rank of a CPU gloo group for ``tests/test_torch_moe_ep.py``: the
port's ``moe_ffn`` and ``moe_ffn_dense`` on a (data, model) device mesh,
their inputs and weights placed as ``train/sharding.py`` places a layer's,
forward and backward, with the shapes of every expert product each rank
runs recorded.

Spawned (``multiprocessing`` spawn context) by the test; every rank builds
the same numpy inputs (``inputs``) and keeps its own shard of them.  Rank 0
writes each case's outputs and gradients as whole arrays into the job's
directory; every rank writes the products it ran.
"""

from __future__ import annotations

import json
import os

import numpy as np

def _layer():
    from repro_torch.configs import get_config

    cfg = get_config("olmoe-1b-7b").reduced()
    return cfg.d_model, cfg.num_experts, cfg.d_ff, cfg.top_k


# reduced olmoe's layer: d_model 64, 4 experts of d_ff 128, top-2
D, E, F, K = _layer()
# name -> (T, route, capacity factor, mlp): 48 rows split over every mesh's
# ranks; 42 over no model axis of 4 or of 2 beside 2 data ranks (the
# all-gather combine); 45 over no data axis (rows replicated); "drops" cuts
# the capacity so pairs drop across data ranks, its experts writing
# disjoint columns (``inputs``) so a dropped (token, slot) reads zeros in
# its expert's columns
CASES = {
    "dispatch": (48, "moe_ffn", 1.25, "swiglu"),
    "drops": (48, "moe_ffn", 0.5, "geglu"),
    "dense": (48, "moe_ffn_dense", None, "swiglu"),
    "odd_rows": (42, "moe_ffn", 1.25, "swiglu"),
    "odd_rows_dense": (42, "moe_ffn_dense", None, "swiglu"),
    "replicated_rows": (45, "moe_ffn", 1.25, "swiglu"),
}
AUX_WEIGHT = 3.0


def inputs(case):
    """(x, router, w1, w3, w2, the output's cotangent), f32 numpy."""
    t, _, _, _ = CASES[case]
    rng = np.random.default_rng(sorted(CASES).index(case))
    x = rng.normal(0, 1, (t, D)).astype(np.float32)
    router = rng.normal(0, 1, (D, E)).astype(np.float32)
    w1, w3 = (rng.normal(0, D ** -0.5, (E, D, F)).astype(np.float32) for _ in range(2))
    w2 = rng.normal(0, F ** -0.5, (E, F, D)).astype(np.float32)
    if case == "drops":
        block = D // E
        for e in range(E):
            w2[e, :, :e * block] = 0.0
            w2[e, :, (e + 1) * block:] = 0.0
    cot = rng.normal(0, 1, (t, D)).astype(np.float32)
    return x, router, w1, w3, w2, cot


def products(fn):
    """(result of fn(), [shapes of the operands of every product op run
    on this rank's own tensors])."""
    import torch
    from torch.distributed.tensor import DTensor
    from torch.utils._python_dispatch import TorchDispatchMode

    ops = {torch.ops.aten.bmm.default, torch.ops.aten.mm.default,
           torch.ops.aten.matmul.default, torch.ops.aten.baddbmm.default}

    class Hook(TorchDispatchMode):
        def __init__(self):
            super().__init__()
            self.shapes = []

        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            if any(issubclass(t, DTensor) for t in types):
                return NotImplemented
            if func in ops:
                self.shapes.append([list(a.shape) for a in args if isinstance(a, torch.Tensor)])
            return func(*args, **(kwargs or {}))

    with Hook() as hook:
        out = fn()
    return out, hook.shapes


def run(rank, world, store_path, shape, out_dir):
    import torch
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh
    from torch.distributed.tensor import distribute_tensor

    from repro_torch.models import moe
    from repro_torch.train import sharding

    torch.set_num_threads(1)
    dist.init_process_group("gloo", store=dist.FileStore(store_path, world),
                            rank=rank, world_size=world)
    try:
        mesh = init_device_mesh("cpu", shape, mesh_dim_names=("data", "model"))
        tag = "x".join(map(str, shape))
        ran = {}

        def place(t, spec):
            return distribute_tensor(torch.from_numpy(t), mesh, sharding.placements(spec, mesh),
                                     src_data_rank=None).requires_grad_(True)

        for case, (t, route, cf, mlp) in CASES.items():
            x, router, w1, w3, w2, cot = inputs(case)
            xd = place(x, sharding.batch_pspec(mesh, t) + (None,))
            ws = [place(a, sharding.param_pspec(n, a.shape, mesh, scan_layers=False))
                  for n, a in (("router", router), ("e_w1", w1), ("e_w3", w3), ("e_w2", w2))]
            before = moe.routes["expert_parallel"]
            if route == "moe_ffn":
                (y, aux), fwd = products(lambda: moe.moe_ffn(xd, *ws, top_k=K, capacity_factor=cf,
                                                             mlp_kind=mlp))
            else:
                y, fwd = products(lambda: moe.moe_ffn_dense(xd, *ws, top_k=K, mlp_kind=mlp))
                aux = None
            assert moe.routes["expert_parallel"] == before + 1 and y.placements == xd.placements
            loss = (y * distribute_tensor(torch.from_numpy(cot), mesh, y.placements,
                                          src_data_rank=None)).sum()
            if aux is not None:
                loss = loss + AUX_WEIGHT * aux
            _, bwd = products(loss.backward)
            # the expert gradients come out placed as their parameters
            assert all(w.grad.placements == w.placements for w in ws), case
            ran[case] = {"forward": fwd, "backward": bwd}
            # every rank gathers (a collective); rank 0 writes
            arrays = {"y": y.full_tensor().detach().numpy(),
                      "grad_x": xd.grad.full_tensor().numpy()}
            if aux is not None:
                arrays["aux"] = np.array(float(aux.full_tensor().detach()))
            for n, w in zip(("router", "w1", "w3", "w2"), ws):
                arrays[f"grad_{n}"] = w.grad.full_tensor().numpy()
            if rank == 0:
                np.savez(os.path.join(out_dir, f"{tag}_{case}.npz"), **arrays)
        with open(os.path.join(out_dir, f"{tag}_products_{rank}.json"), "w") as f:
            json.dump(ran, f)
    finally:
        dist.destroy_process_group()
