"""Production meshes of the port: the reference's ``launch/mesh.py`` as
torch ``DeviceMesh`` es, and the fake world that stands in for its 512
placeholder devices.

Defined as functions, so importing this module touches no process group:
the dry run enters :func:`fake_world` (a ``"fake"`` process group of 256 or
512 ranks, the counterpart of the reference's
``--xla_force_host_platform_device_count=512``) and only then builds a mesh
on it.  A mesh needs a default process group of exactly its size.
"""

from __future__ import annotations

import contextlib

import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh, init_device_mesh

TP = 16          # model-parallel degree (divides every arch's sharded dims)
POD_DATA = 16    # data-parallel degree within a pod (16 x 16 = 256 cards a pod)
PODS = 2


def make_production_mesh(*, multi_pod: bool = False, device_type: str = "cuda") -> DeviceMesh:
    """(16, 16) ``("data", "model")``, or (2, 16, 16) ``("pod", "data",
    "model")`` with ``multi_pod``, over the default process group."""
    shape = (PODS, POD_DATA, TP) if multi_pod else (POD_DATA, TP)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    return init_device_mesh(device_type, shape, mesh_dim_names=axes)


def make_host_mesh(device_type: str = "cuda") -> DeviceMesh:
    """A (1, 1) ``("data", "model")`` mesh over the caller's device: the
    one rank of a one-rank default process group."""
    return init_device_mesh(device_type, (1, 1), mesh_dim_names=("data", "model"))


@contextlib.contextmanager
def fake_world(n: int, rank: int = 0):
    """A ``"fake"`` default process group of ``n`` ranks, this process
    being ``rank``: collectives move no data and every rank's local shapes
    are this one's.  Destroyed on exit, whatever happens inside; refused
    when a default group already exists."""
    from torch.testing._internal.distributed.fake_pg import FakeStore

    if dist.is_initialized():
        raise RuntimeError("a default process group already exists; destroy it first")
    dist.init_process_group("fake", store=FakeStore(), rank=rank, world_size=n)
    try:
        yield
    finally:
        dist.destroy_process_group()
