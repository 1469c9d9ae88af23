"""``launch/dryrun.py``, ``launch/mesh.py`` and ``launch/trace_analysis.py``
of the port, on the CPU, each inside ``fake_world`` (which must leave no
default process group behind):

* the CLI writes ``ok`` rows of reduced cells on a (4, 2) fake mesh that
  ``roofline`` reads (``test_torch_dryrun_cells.py`` runs every cell);
* ``argument_bytes`` is the sum of the local shard bytes the specs give;
* a ``[Shard(0), Replicate()]`` x ``[Shard(0), Shard(1)]`` product on a
  fake (16, 16) mesh is counted at its local shapes, one all-gather;
* the extrapolated counts of a deeper cell equal its direct trace;
* the (1, 1) trace's FLOPs equal ``TraceAnalysis`` over the real step;
* the fake (2, 1) trace's collective counts equal a real gloo (2, 1) run's.
"""

import dataclasses
import json
import multiprocessing
import os

import numpy as np
import pytest
import torch
import torch.distributed as dist
from torch._subclasses.fake_tensor import FakeTensorMode
from torch.distributed.tensor import Replicate, Shard, distribute_tensor

import torch_mesh_worker as worker
from repro_torch.configs import get_config
from repro_torch.launch import dryrun, roofline
from repro_torch.launch.mesh import fake_world, make_host_mesh
from repro_torch.launch.specs import SHAPES, ShapeSpec
from repro_torch.launch.trace_analysis import TraceAnalysis
from repro_torch.train import sharding

CUT = {"train_4k": (32, 8), "prefill_32k": (64, 4), "decode_32k": (64, 4), "long_500k": (256, 1)}


def _cut(name):
    seq, batch = CUT[name]
    return dataclasses.replace(SHAPES[name], seq_len=seq, global_batch=batch)


def _mesh(d, m):
    from torch.distributed.device_mesh import init_device_mesh
    return init_device_mesh("cpu", (d, m), mesh_dim_names=("data", "model"))


@pytest.fixture
def world():
    """fake_world of n ranks, checked to leave no default group behind."""
    worlds = []

    def enter(n):
        ctx = fake_world(n)
        worlds.append(ctx)
        ctx.__enter__()
    yield enter
    for ctx in worlds:
        ctx.__exit__(None, None, None)
    assert not dist.is_initialized()


def test_the_cli_writes_ok_rows_that_the_roofline_reads(tmp_path, capsys):
    out = str(tmp_path / "dryrun.json")
    args = ["--device", "cpu", "--reduced", "--mesh-shape", "4,2", "--arch", "hymba-1.5b",
            "--out", out]
    for shape in ("decode_32k", "long_500k"):
        assert dryrun.main(args + ["--shape", shape]) == 0
    assert not dist.is_initialized()
    rows = json.load(open(out))
    assert [rows[k]["status"] for k in sorted(rows)] == ["ok", "ok"]
    table = roofline.analyze(out, chips=8)
    assert all(r["status"] == "ok" and r["dominant"] for r in table.values())
    roofline.main(["--json", out, "--chips", "8"])
    assert "hymba-1.5b|long_500k" in capsys.readouterr().out


def _local_bytes(shape, dtype, placements, mesh_shape):
    """Bytes of rank 0's shard: each sharded dim cut as torch.chunk cuts it."""
    shape = list(shape)
    for size, p in zip(mesh_shape, placements):
        if isinstance(p, Shard):
            shape[p.dim] = -(-shape[p.dim] // size)
    return int(np.prod(shape)) * torch.empty((), dtype=dtype).element_size()


def test_argument_bytes_are_the_local_shards_of_the_specs(world):
    world(8)
    mesh = _mesh(4, 2)
    cfg = get_config("internlm2-1.8b").reduced()
    shape = _cut("train_4k")
    res = dryrun.lower_cell("internlm2-1.8b", "train_4k", mesh, device="cpu", cfg=cfg,
                            shape=shape)
    with FakeTensorMode():
        from repro_torch.models import Model
        params = dict(Model(cfg, device="cpu").named_parameters())
    want = 4                                                    # the int32 step
    for n, spec in sharding.params_pspecs(params, mesh).items():
        pl = sharding.placements(spec, mesh)
        want += _local_bytes(params[n].shape, params[n].dtype, pl, (4, 2))
        want += 2 * _local_bytes(params[n].shape, torch.float32, pl, (4, 2))   # mu, nu
    for k, (s, dt) in dryrun.batch_specs(cfg, shape).items():
        pl = sharding.placements(sharding.batch_pspec(mesh, s[0]) + (None,) * (len(s) - 1), mesh)
        want += _local_bytes(s, dt, pl, (4, 2))
    assert res["memory"]["argument_bytes"] == want


def test_a_sharded_product_is_counted_at_its_local_shapes(world):
    world(256)
    mesh = _mesh(16, 16)
    with FakeTensorMode():
        x = distribute_tensor(torch.empty(256, 4096, 2048, dtype=torch.bfloat16), mesh,
                              [Shard(0), Replicate()], src_data_rank=None)
        w = distribute_tensor(torch.empty(2048, 2048, dtype=torch.bfloat16), mesh,
                              [Shard(0), Shard(1)], src_data_rank=None)
        with TraceAnalysis(mesh.size()) as trace:
            y = x @ w
    got = trace.result()
    assert tuple(y.to_local().shape) == (16, 4096, 128)
    assert got["flops_per_device"] == 2 * (16 * 4096) * 2048 * 128      # not 256 x that
    assert got["collective_counts"] == {"all-gather": 1}
    # the weight's (128, 128) bf16 shard gathered over the 16 data ranks
    assert got["collective_bytes_per_device"] == 2048 * 128 * 2 * 15 / 16


def test_extrapolated_counts_equal_the_direct_trace(world):
    """A decoder stack deeper than two layers, of four microbatches: the fit
    from the cut traces gives every count of the direct trace."""
    world(8)
    mesh = _mesh(4, 2)
    for arch in ("internlm2-1.8b",):
        cfg = dataclasses.replace(get_config(arch).reduced(), num_layers=3)
        shape = ShapeSpec("cell", "train", 16, 16)
        fit = dryrun.lower_cell(arch, "cell", mesh, device="cpu", cfg=cfg, shape=shape)
        assert len(fit["traced"]) == 5
        direct = dryrun._trace(cfg, shape, mesh, "baseline", "cpu")
        prof = fit["hlo_profile"]
        for k in ("flops_per_device", "hbm_bytes_per_device", "collective_bytes_per_device"):
            assert prof[k] == pytest.approx(direct[k], rel=1e-9), (arch, k)
        assert prof["collective_counts"] == {k[6:]: v for k, v in direct.items()
                                             if k.startswith("count:")}
        for k in ("argument_bytes", "output_bytes"):
            assert fit["memory"][k] == direct[k]


def test_host_mesh_trace_flops_equal_the_real_step():
    """(1, 1) host mesh: the fake trace's FLOPs against ``TraceAnalysis``
    over the same step run for real on the CPU."""
    cfg = get_config("internlm2-1.8b").reduced()
    shape = ShapeSpec("cell", "train", 32, 2)
    with fake_world(1):
        fake = dryrun.lower_cell("internlm2-1.8b", "cell", make_host_mesh("cpu"), device="cpu",
                                 cfg=cfg, shape=shape)
    dist.init_process_group("gloo", store=dist.HashStore(), rank=0, world_size=1)
    try:
        mesh = make_host_mesh("cpu")
        fn, args, _ = dryrun.build_cell(cfg, shape, mesh, "baseline", "cpu")
        with TraceAnalysis(mesh.size()) as trace:
            fn(*args)
    finally:
        dist.destroy_process_group()
    assert fake["traced"] == [{"num_layers": 2, "microbatches": 2}]
    assert fake["hlo_profile"]["flops_per_device"] == trace.result()["flops_per_device"] > 0


def test_fake_collective_counts_equal_a_real_gloo_run(tmp_path):
    _fake_counts_equal_real(tmp_path, "internlm2-1.8b", (2, 1))


def test_fake_moe_collective_counts_equal_a_real_gloo_run(tmp_path):
    """Reduced olmoe on (2, 2): the expert-parallel route's all-to-alls,
    gathers and reduce-scatters, counted alike on the fake and the real
    group, and equal in bytes by kind."""
    fake, real = _fake_counts_equal_real(tmp_path, "olmoe-1b-7b", (2, 2))
    assert fake["hlo_profile"]["collective_counts"]["all-to-all"] > 0
    got = fake["hlo_profile"]["collective_bytes_by_kind"]
    assert got.keys() == real["collective_bytes_by_kind"].keys()
    for k, v in real["collective_bytes_by_kind"].items():
        assert got[k] == pytest.approx(v, rel=1e-9), k


def _fake_counts_equal_real(tmp_path, arch, mesh_shape, seq=32, batch=4):
    world = mesh_shape[0] * mesh_shape[1]
    with fake_world(world):
        fake = dryrun.lower_cell(arch, "cell", _mesh(*mesh_shape), device="cpu",
                                 cfg=worker.reduced(arch),
                                 shape=ShapeSpec("cell", "train", seq, batch))
    assert not dist.is_initialized()
    ctx = multiprocessing.get_context("spawn")
    out = str(tmp_path / "counts.json")
    os.environ.setdefault("GLOO_SOCKET_IFNAME", "lo")
    procs = [ctx.Process(target=worker.trace_step,
                         args=(r, world, str(tmp_path / "store"), mesh_shape, out, arch, seq,
                               batch))
             for r in range(world)]
    for p in procs:
        p.start()
    for p in procs:
        p.join(240)
    assert not any(p.is_alive() for p in procs) and all(p.exitcode == 0 for p in procs)
    real = json.load(open(out))
    assert fake["hlo_profile"]["collective_counts"] == real["collective_counts"]
    assert sum(real["collective_counts"].values()) > 0
    return fake, real
