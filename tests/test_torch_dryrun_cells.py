"""Every reduced (arch x shape kind) cell of ``launch/dryrun.py`` on a (4,
2) fake mesh, on the CPU: ``ok``, or ``skipped`` as ``cell_supported``
says, with per-device FLOPs and bytes; the shapes cut to CPU size (8 x 32
tokens to train in 2 microbatches, 4 x 64 to prefill and decode, 1 x 256
for the long decode).  ``fake_world`` must leave no default process group
behind.
"""

import dataclasses

import pytest
import torch.distributed as dist

from repro_torch.configs import get_config, list_architectures
from repro_torch.launch import dryrun
from repro_torch.launch.mesh import fake_world
from repro_torch.launch.specs import SHAPES, cell_supported

CUT = {"train_4k": (32, 8), "prefill_32k": (64, 4), "decode_32k": (64, 4), "long_500k": (256, 1)}


def _cut(name):
    seq, batch = CUT[name]
    return dataclasses.replace(SHAPES[name], seq_len=seq, global_batch=batch)


@pytest.mark.parametrize("arch", list_architectures())
def test_every_reduced_cell_is_ok_or_skipped(arch):
    from torch.distributed.device_mesh import init_device_mesh

    with fake_world(8):
        mesh = init_device_mesh("cpu", (4, 2), mesh_dim_names=("data", "model"))
        cells = _cells(arch, mesh)
    assert not dist.is_initialized()
    for name, (res, ok, reason) in cells.items():
        assert res["status"] == ("ok" if ok else "skipped"), (name, res.get("error"))
        if ok:
            prof = res["hlo_profile"]
            assert prof["flops_per_device"] > 0 and prof["num_partitions"] == 8
            assert 0 < res["memory"]["argument_bytes"] <= res["memory"]["peak_bytes"]
        else:
            assert res["reason"] == reason


def _cells(arch, mesh):
    cfg = get_config(arch).reduced()
    out = {}
    for name in SHAPES:
        shape = _cut(name)
        res = dryrun.lower_cell(arch, name, mesh, device="cpu", cfg=cfg, shape=shape)
        out[name] = (res, *cell_supported(cfg, shape))
    return out




def test_moe_expert_products_split_over_the_mesh(monkeypatch):
    """Reduced olmoe x train_4k cut to 8 x 32 tokens, traced whole: the
    per-device FLOPs of the expert products (the cell's only ``bmm`` s) on
    the fake (4, 2) mesh are 1/8 of the same cell's on a (1, 1) mesh,
    within the capacity padding.  (4, 2): 2 microbatches of 128 tokens,
    capacity 80 padded to 4 x 20, 2 experts a rank; (1, 1): 8 of 32,
    capacity 20, all 4 experts."""
    import torch
    from torch.distributed.device_mesh import init_device_mesh
    from torch.utils.flop_counter import flop_registry

    from repro_torch.launch.trace_analysis import TraceAnalysis
    from repro_torch.models import moe

    class Products(TraceAnalysis):
        runs = []

        def __init__(self, n):
            super().__init__(n)
            self.expert_flops = 0.0
            Products.runs.append(self)

        def _count(self, func, args, kwargs, out):
            super()._count(func, args, kwargs, out)
            if func is torch.ops.aten.bmm.default:
                self.expert_flops += float(flop_registry[func._overloadpacket](
                    *args, **kwargs, out_val=out))

    monkeypatch.setattr(dryrun, "TraceAnalysis", Products)
    cfg = get_config("olmoe-1b-7b").reduced()
    shape = _cut("train_4k")
    flops = {}
    for mesh_shape in ((1, 1), (4, 2)):
        before = moe.routes["expert_parallel"]
        with fake_world(mesh_shape[0] * mesh_shape[1]):
            mesh = init_device_mesh("cpu", mesh_shape, mesh_dim_names=("data", "model"))
            dryrun._trace(cfg, shape, mesh, "baseline", "cpu")
        flops[mesh_shape] = Products.runs[-1].expert_flops
        # every layer, each microbatch's forward and its remat forward
        calls = 2 * cfg.num_layers * dryrun.microbatches(shape, mesh)
        assert moe.routes["expert_parallel"] - before == calls
    tokens = shape.global_batch // 2 * shape.seq_len     # a (4, 2) microbatch
    cap = max(int(tokens * cfg.top_k * cfg.capacity_factor / cfg.num_experts), cfg.top_k)
    padded = -(-cap // 4) * 4
    ratio = flops[(4, 2)] / flops[(1, 1)]
    assert flops[(1, 1)] > 0 and 1 / 8 <= ratio <= padded / cap / 8, ratio
