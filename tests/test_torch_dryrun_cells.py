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


