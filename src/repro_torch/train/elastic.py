"""Elastic scaling and straggler mitigation of the port: the reference's
``train/elastic.py``.

``plan_mesh`` chooses the largest healthy (data, model) mesh for the
surviving devices: the tensor-parallel degree is kept, the data extent
shrinks to what remains.  ``make_mesh`` builds that plan's ``DeviceMesh``
over the default process group's ranks.  After a failure: plan_mesh(the
surviving count), make_mesh, ``checkpoint.restore(..., shardings=...)`` with
``sharding.params_shardings`` on the new mesh, and resume from the
manifest's step.  ``StragglerWatchdog`` is the step-time monitor: an EWMA of
step latency with a multiplicative threshold; slow steps are recorded and
surfaced so the launcher can trigger a re-mesh.  Both are pure logic.
"""

from __future__ import annotations

import dataclasses
import time
from typing import List, Optional, Sequence, Tuple

import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh


@dataclasses.dataclass(frozen=True)
class MeshPlan:
    shape: Tuple[int, ...]
    axis_names: Tuple[str, ...]
    devices_used: int
    data_parallel: int
    global_batch: int


def plan_mesh(num_devices: int, *, tp: int = 16, per_replica_batch: int = 8,
              prefer_pods: bool = False, pod_size: int = 256) -> MeshPlan:
    """Largest (data, model=tp) mesh that fits the surviving devices."""
    if num_devices < tp:
        raise ValueError(
            f"cannot keep TP={tp} with only {num_devices} devices; "
            "reshard checkpoints to a smaller TP first")
    data = num_devices // tp
    if prefer_pods and num_devices >= pod_size:
        pods = num_devices // pod_size
        data_in_pod = pod_size // tp
        return MeshPlan(shape=(pods, data_in_pod, tp),
                        axis_names=("pod", "data", "model"),
                        devices_used=pods * pod_size,
                        data_parallel=pods * data_in_pod,
                        global_batch=pods * data_in_pod * per_replica_batch)
    return MeshPlan(shape=(data, tp), axis_names=("data", "model"),
                    devices_used=data * tp, data_parallel=data,
                    global_batch=data * per_replica_batch)


def make_mesh(plan: MeshPlan, devices: Optional[Sequence[int]] = None, *,
              device_type: str = "cuda") -> DeviceMesh:
    """The plan's ``DeviceMesh``: ``plan.shape`` with ``plan.axis_names``
    over ``devices`` (ranks of the default process group; the first
    ``plan.devices_used`` of its world by default).  Raises when the world
    holds fewer ranks than the plan uses."""
    world = dist.get_world_size() if dist.is_initialized() else 0
    if world < plan.devices_used:
        raise ValueError(f"the plan uses {plan.devices_used} devices; the default process "
                         f"group has {world}")
    ranks = list(devices if devices is not None else range(world))[: plan.devices_used]
    if len(ranks) < plan.devices_used:
        raise ValueError(f"the plan uses {plan.devices_used} devices; {len(ranks)} given")
    return DeviceMesh(device_type, torch.tensor(ranks).reshape(plan.shape),
                      mesh_dim_names=plan.axis_names)


class StragglerWatchdog:
    """EWMA step-time monitor; flags steps slower than ``threshold`` x the
    EWMA."""

    def __init__(self, threshold: float = 2.0, alpha: float = 0.1, warmup: int = 3):
        self.threshold = threshold
        self.alpha = alpha
        self.warmup = warmup
        self.ewma: Optional[float] = None
        self.steps = 0
        self.slow_steps: List[Tuple[int, float]] = []
        self._t0: Optional[float] = None

    def start(self):
        self._t0 = time.perf_counter()

    def stop(self) -> bool:
        """Returns True if this step was a straggler."""
        return self.observe(time.perf_counter() - self._t0)

    def observe(self, dt: float) -> bool:
        self.steps += 1
        if self.ewma is None:
            self.ewma = dt
            return False
        slow = self.steps > self.warmup and dt > self.threshold * self.ewma
        if slow:
            # do not fold outliers into the baseline
            self.slow_steps.append((self.steps, dt))
        else:
            self.ewma = (1 - self.alpha) * self.ewma + self.alpha * dt
        return slow

    @property
    def should_remesh(self) -> bool:
        """Persistent stragglers (>= 3 of the last 10 steps): act."""
        recent = [s for s, _ in self.slow_steps if s > self.steps - 10]
        return len(recent) >= 3
