"""The port's training step on a device mesh (``train/sharding.py``,
DTensor parameters and moments, the kernels' sharding rules), on the CPU:
gloo process groups of 2 and 4 ranks on (2, 1), (1, 2) and (2, 2) meshes,
reduced internlm2 (flash), hymba (GLA) and olmoe (MoE, expert-parallel;
also on (1, 4), one expert a rank), and internlm2 with one kv head (its
heads repeated where a mesh axis does not divide them).

Two sharded steps match the unsharded port step from the same seed (which
``test_torch_train.py`` holds to the reference) within rtol 1e-5, in loss and
in every ``full_tensor()`` parameter; a checkpoint of the (2, 2) state
restores bitwise onto (2, 1) and onto no mesh; and with ``shard_hints`` None
the forward is the plain one, op for op, while a one-rank mesh with hints
gives it bitwise.
"""

import multiprocessing
import os

import numpy as np
import pytest
import torch
import torch.distributed as dist

import torch_mesh_worker as worker
from repro_torch.configs import get_config
from repro_torch.models import Model
from repro_torch.train import checkpoint
from repro_torch.train.optimizer import init_opt_state
from repro_torch.train.step import TrainState

MESHES = [(2, 1), (1, 2), (2, 2)]
MOE_ARCH = "olmoe-1b-7b"
JOIN_S = 240


def _spawn(shape, out_dir, restore_from=None, archs=worker.ARCHS):
    """Runs one gloo group of prod(shape) ranks to its end (or fails)."""
    ctx = multiprocessing.get_context("spawn")
    world = shape[0] * shape[1]
    store = os.path.join(out_dir, "store_" + "x".join(map(str, shape)))
    os.environ.setdefault("GLOO_SOCKET_IFNAME", "lo")
    procs = [ctx.Process(target=worker.run,
                         args=(r, world, store, shape, out_dir, restore_from, archs))
             for r in range(world)]
    for p in procs:
        p.start()
    return procs


def _join(procs):
    for p in procs:
        p.join(JOIN_S)
    alive = [p for p in procs if p.is_alive()]
    for p in alive:
        p.kill()
    assert not alive, f"{len(alive)} ranks still running after {JOIN_S} s"
    assert all(p.exitcode == 0 for p in procs), [p.exitcode for p in procs]


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """Every mesh's results: (2, 2) and (1, 2) at once, then (2, 1), which
    also restores the (2, 2) checkpoint, beside olmoe alone on (1, 4)."""
    out = str(tmp_path_factory.mktemp("mesh"))
    first = _spawn((2, 2), out) + _spawn((1, 2), out)
    _join(first)
    _join(_spawn((2, 1), out, restore_from=os.path.join(out, "ckpt_2x2"))
          + _spawn((1, 4), out, archs=(MOE_ARCH,)))
    return out


@pytest.fixture(scope="module")
def unsharded():
    out = {}
    for arch in worker.ARCHS:
        _, state, losses = worker.train(worker.reduced(arch))
        out[arch] = (losses, {n: p.detach().numpy() for n, p in state.params.items()})
    return out


def _check_steps(runs, unsharded, arch, shape):
    got = np.load(os.path.join(runs, f"{'x'.join(map(str, shape))}_{arch.replace('/', '_')}.npz"))
    losses, params = unsharded[arch]
    np.testing.assert_allclose(got["losses"], losses, rtol=1e-5)
    assert all(np.isfinite(losses))
    # rtol 1e-5 of each element, and of the leaf's largest magnitude for
    # elements near zero (partial sums over a shard add in another order)
    for n, want in params.items():
        np.testing.assert_allclose(got[f"param/{n}"], want, rtol=1e-5,
                                   atol=1e-5 * float(np.abs(want).max()), err_msg=n)


@pytest.mark.parametrize("shape", MESHES, ids=lambda s: "x".join(map(str, s)))
@pytest.mark.parametrize("arch", worker.ARCHS)
def test_sharded_steps_match_the_unsharded_step(runs, unsharded, arch, shape):
    _check_steps(runs, unsharded, arch, shape)


def test_moe_steps_on_a_model_axis_of_four_match_the_unsharded_step(runs, unsharded):
    """Reduced olmoe's 4 experts over a model axis of 4: each rank one
    expert, the tokens' rows split four ways to route and combine."""
    _check_steps(runs, unsharded, MOE_ARCH, (1, 4))


def test_elastic_restore_across_meshes_is_bitwise(runs):
    """The (2, 2) checkpoint onto a (2, 1) mesh and onto no mesh: every
    parameter, moment and the step bitwise the saved files; the manifest
    names the saver's mesh."""
    ckpt = os.path.join(runs, "ckpt_2x2")
    step_dir = os.path.join(ckpt, f"step_{worker.STEPS:08d}")
    saved = lambda name: np.load(os.path.join(step_dir, name + ".npy"))
    import json
    with open(os.path.join(step_dir, "manifest.json")) as f:
        assert json.load(f)["mesh"] == {"shape": [2, 2], "axis_names": ["data", "model"]}
    onto = np.load(os.path.join(runs, "restored_2x1.npz"))
    model = Model(worker.reduced(worker.ARCHS[0]), device="cpu")
    params = dict(model.named_parameters())
    plain = TrainState(params, init_opt_state(params), None)
    checkpoint.restore(ckpt, worker.STEPS, plain)
    for n in params:
        want = saved(".params__" + n.replace(".", "__"))
        assert np.array_equal(onto[f"param/{n}"], want), n
        assert np.array_equal(params[n].detach().numpy(), want), n
        assert np.array_equal(onto[f"mu/{n}"], saved(".opt__.mu__" + n.replace(".", "__"))), n
    assert int(onto["step"]) == int(saved(".opt__.step")) == worker.STEPS


def test_shard_hints_none_runs_the_plain_forward():
    """With plain parameters and ``shard_hints`` None, a forward runs the
    same aten ops as with hints set (which touch nothing off a mesh) and
    gives the same bits."""
    from torch.utils._python_dispatch import TorchDispatchMode

    class Ops(TorchDispatchMode):
        def __init__(self):
            super().__init__()
            self.ops = []

        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            self.ops.append(str(func))
            return func(*args, **(kwargs or {}))

    cfg = get_config("hymba-1.5b").reduced()
    model = Model(cfg, device="cpu").init(torch.Generator().manual_seed(1))
    tok = torch.from_numpy(np.random.default_rng(2).integers(0, cfg.vocab_size, (2, 24)))
    runs = []
    for hints in (None, {"dp": ("data",), "tp": "model", "dp_ok": True, "sp": False}):
        model.shard_hints = hints
        with Ops() as ops, torch.no_grad():
            logits, _ = model({"tokens": tok})
        runs.append((ops.ops, logits))
    assert runs[0][0] == runs[1][0]
    assert torch.equal(runs[0][1], runs[1][1])


def test_one_rank_mesh_with_hints_is_bitwise_the_plain_forward():
    """A (1, 1) gloo mesh, parameters sharded and hints set: the forward's
    logits bitwise the plain model's."""
    from torch.distributed.device_mesh import init_device_mesh

    from repro_torch.train import sharding

    cfg = get_config("internlm2-1.8b").reduced()
    plain = Model(cfg, device="cpu").init(torch.Generator().manual_seed(1))
    tok = torch.from_numpy(np.random.default_rng(2).integers(0, cfg.vocab_size, (2, 24)))
    with torch.no_grad():
        want, _ = plain({"tokens": tok})
    dist.init_process_group("gloo", store=dist.HashStore(), rank=0, world_size=1)
    try:
        mesh = init_device_mesh("cpu", (1, 1), mesh_dim_names=("data", "model"))
        model = Model(cfg, device="cpu").init(torch.Generator().manual_seed(1))
        sharding.shard_model(model, mesh)
        model.shard_hints = {"dp": ("data",), "tp": "model", "dp_ok": True, "sp": False}
        with torch.no_grad():
            got, _ = model({"tokens": tok})
        assert torch.equal(got.full_tensor(), want)
    finally:
        dist.destroy_process_group()


def test_one_rank_mesh_training_is_bitwise_the_plain_training():
    """Three steps of 2 microbatches on a (1, 1) gloo mesh, parameters and
    moments DTensors and the dry run's hints set, against the plain steps
    from the same seed: losses and parameters bitwise (every op a local
    one, as on the card's host mesh)."""
    _one_rank_training_is_bitwise("internlm2-1.8b")


def test_one_rank_mesh_moe_training_is_bitwise_the_plain_training():
    """The same for reduced olmoe: on the (1, 1) mesh every MoE call takes
    the expert-parallel route (one data rank, one expert group), bitwise
    the plain route's."""
    from repro_torch.models import moe

    before = dict(moe.routes)
    _one_rank_training_is_bitwise(MOE_ARCH)
    # 3 steps x 2 microbatches x 2 layers, forward and remat forward
    assert moe.routes["expert_parallel"] - before.get("expert_parallel", 0) == 24
    assert moe.routes["local"] - before.get("local", 0) == 24


def _one_rank_training_is_bitwise(arch):
    from torch.distributed.device_mesh import init_device_mesh

    from repro_torch.launch import dryrun
    from repro_torch.launch.specs import ShapeSpec
    from repro_torch.train import sharding
    from repro_torch.train.optimizer import AdamWConfig
    from repro_torch.train.step import make_train_step

    cfg = get_config(arch).reduced()
    shape = ShapeSpec("host", "train", 32, 4)
    batches = [{k: torch.from_numpy(v) for k, v in b.items()}
               for b in worker.batches(cfg, seed=8)] * 2

    def run(mesh):
        model = Model(cfg, device="cpu").init(torch.Generator().manual_seed(3))
        model.requires_grad_(True)
        if mesh is not None:
            sharding.shard_model(model, mesh)
            model.shard_hints = dryrun.shard_hints(cfg, shape, mesh, "baseline")
        params = dict(model.named_parameters())
        state = TrainState(params, init_opt_state(params), None)
        fn = make_train_step(model, AdamWConfig(**worker.OPT), microbatches=2)
        losses = []
        for b in batches[:3]:
            state, m = fn(state, b)
            losses.append(m["loss"].full_tensor() if mesh is not None else m["loss"])
        return losses, {n: worker.full(p) for n, p in state.params.items()}

    want_losses, want = run(None)
    dist.init_process_group("gloo", store=dist.HashStore(), rank=0, world_size=1)
    try:
        losses, got = run(init_device_mesh("cpu", (1, 1), mesh_dim_names=("data", "model")))
    finally:
        dist.destroy_process_group()
    assert all(torch.equal(a, b) for a, b in zip(losses, want_losses))
    for n in want:
        assert np.array_equal(got[n], want[n]), n
