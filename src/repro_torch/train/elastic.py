"""Elastic scaling and straggler mitigation of the port: the reference's
``train/elastic.py`` without ``make_mesh``.

``plan_mesh`` chooses the largest healthy (data, model) mesh for the
surviving devices: the tensor-parallel degree is kept, the data extent
shrinks to what remains.  ``StragglerWatchdog`` is the step-time monitor: an
EWMA of step latency with a multiplicative threshold; slow steps are recorded
and surfaced so the launcher can trigger a re-mesh.  Both are pure logic.
The reference's ``make_mesh`` builds a ``jax.sharding.Mesh``; its port (a
``torch.distributed`` device mesh) comes with the port's sharding (ROADMAP).
"""

from __future__ import annotations

import dataclasses
import time
from typing import List, Optional, Tuple


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
