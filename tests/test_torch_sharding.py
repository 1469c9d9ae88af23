"""``train/sharding.py`` of the port against the reference's rules, on the
CPU: every parameter leaf of the ten registry configs (encoder stacks
included) on (1, 1), (16, 16) and (2, 16, 16) meshes, the batch specs at
batch 1 and 256, each config's ``decode_32k`` cache specs, the reference's
divisibility cases, then ``placements``, ``plan_mesh`` and ``make_mesh``.

The reference reads a ``jax.sharding.AbstractMesh`` (no devices), the port
a ``MeshShape`` (no process group).  A spec entry that is a one-name tuple
equals that name (``PartitionSpec`` treats them alike), so entries are
compared after that normalisation, one for one.
"""

import dataclasses

import pytest
import torch
from jax.sharding import AbstractMesh
from torch._subclasses.fake_tensor import FakeTensorMode
from torch.distributed.tensor import Replicate, Shard

from repro.models import build_model
from repro.train import elastic as ref_elastic
from repro.train import sharding as ref
from repro_torch.configs import get_config, list_architectures
from repro_torch.launch.mesh import fake_world
from repro_torch.models import Model
from repro_torch.models.model import cache_spec
from repro_torch.train import elastic, sharding
from repro_torch.train.sharding import MeshShape

import jax

MESHES = {"1x1": ((1, 1), ("data", "model")), "16x16": ((16, 16), ("data", "model")),
          "2x16x16": ((2, 16, 16), ("pod", "data", "model"))}


def _both(mesh):
    shape, names = MESHES[mesh]
    return AbstractMesh(shape, names), MeshShape(shape, names)


def _entry(e):
    return e[0] if isinstance(e, tuple) and len(e) == 1 else e


def _same(port, want, where):
    assert tuple(map(_entry, port)) == tuple(map(_entry, tuple(want))), where


def _ref_leaves(tree):
    flat, _ = jax.tree_util.tree_flatten_with_path(tree)
    return {"/".join(str(getattr(k, "key", k)) for k in path): leaf for path, leaf in flat}


@pytest.mark.parametrize("mesh", sorted(MESHES))
@pytest.mark.parametrize("arch", list_architectures())
def test_param_specs_are_the_references(arch, mesh):
    cfg = get_config(arch)
    jmesh, tmesh = _both(mesh)
    want = _ref_leaves(ref.params_pspecs(build_model(cfg).init_abstract(), jmesh))
    with FakeTensorMode():
        params = dict(Model(cfg, device="cpu").named_parameters())
    got = sharding.params_pspecs(params, tmesh)
    assert {n.replace(".", "/") for n in got} == set(want)
    for n, spec in got.items():
        _same(spec, want[n.replace(".", "/")], f"{arch} {n}")
        assert len(spec) == params[n].dim()


@pytest.mark.parametrize("mesh", sorted(MESHES))
@pytest.mark.parametrize("batch", [1, 256])
def test_batch_specs_are_the_references(batch, mesh):
    jmesh, tmesh = _both(mesh)
    _same(sharding.batch_pspec(tmesh, batch), ref.batch_pspec(jmesh, batch), "batch_pspec")
    leaves = {"tokens": (batch, 4096), "frames": (batch, 1500, 1280)}
    want = ref.batch_pspecs({k: jax.ShapeDtypeStruct(v, jax.numpy.int32)
                             for k, v in leaves.items()}, jmesh)
    got = sharding.batch_pspecs(leaves, tmesh)
    for k in leaves:
        _same(got[k], want[k], k)


@pytest.mark.parametrize("arch", list_architectures())
def test_decode_cache_specs_are_the_references(arch):
    cfg = get_config(arch)
    jmesh, tmesh = _both("16x16")
    ref_cache = build_model(cfg).cache_spec(128, 32768)
    want = ref.cache_pspecs(ref_cache, jmesh)
    got = sharding.cache_pspecs(cache_spec(cfg, 128, 32768), tmesh)
    assert got.keys() == want.keys()
    for k in got:
        _same(got[k], want[k], f"{arch} {k}")


def test_divisibility_cases_of_the_reference():
    """``tests/test_launch.py``'s: on a (1, 1) mesh everything divides, odd
    dims included."""
    jmesh, tmesh = _both("1x1")
    for path, shape in (("layers/wq", (24, 2048, 2048)), ("layers/wk", (24, 2047, 129))):
        _same(sharding.param_pspec(path, shape, tmesh), ref.param_pspec(path, shape, jmesh), path)
        assert tuple(map(_entry, sharding.param_pspec(path, shape, tmesh))) == \
            (None, "data", "model")
    jmesh, tmesh = _both("16x16")
    for path, shape in (("layers/wk", (24, 2047, 129)), ("layers/e_w2", (2, 60, 1024, 2048)),
                        ("head", (2048, 100)), ("layers/ln1", (24, 2048))):
        _same(sharding.param_pspec(path, shape, tmesh), ref.param_pspec(path, shape, jmesh), path)


def test_placements_follow_the_spec():
    tmesh = MeshShape((2, 16, 16), ("pod", "data", "model"))
    assert sharding.placements((None, ("pod", "data"), "model"), tmesh) == \
        [Shard(1), Shard(1), Shard(2)]
    assert sharding.placements((None, None), tmesh) == [Replicate()] * 3
    assert sharding.placements((), tmesh) == [Replicate()] * 3
    two = MeshShape((4, 2), ("data", "model"))
    assert sharding.placements(("model", ("data",)), two) == [Shard(1), Shard(0)]
    with pytest.raises(ValueError, match="axis order"):
        sharding.placements((("data", "pod"),), tmesh)
    # a mesh dim of size 1 holds the whole dim: replicated
    assert sharding.placements((("data",), "model"), MeshShape((1, 4), ("data", "model"))) == \
        [Replicate(), Shard(1)]


@pytest.mark.parametrize("n, kw", [(256, {}), (512, {"prefer_pods": True}), (240, {}),
                                   (64, {"tp": 8, "per_replica_batch": 4})])
def test_plan_mesh_is_the_references(n, kw):
    assert dataclasses.asdict(elastic.plan_mesh(n, **kw)) == \
        dataclasses.asdict(ref_elastic.plan_mesh(n, **kw))


def test_make_mesh_builds_the_plan_and_refuses_a_small_world():
    plan = elastic.plan_mesh(32)
    with pytest.raises(ValueError, match="uses 32 devices"):
        elastic.make_mesh(plan, device_type="cpu")          # no process group at all
    with fake_world(16):
        with pytest.raises(ValueError, match="uses 32 devices; the default process group has 16"):
            elastic.make_mesh(plan, device_type="cpu")
    with fake_world(40):
        mesh = elastic.make_mesh(plan, device_type="cpu")
        assert tuple(mesh.shape) == (2, 16) and mesh.mesh_dim_names == ("data", "model")
        assert mesh.mesh.flatten().tolist() == list(range(32))
    assert not torch.distributed.is_initialized()
