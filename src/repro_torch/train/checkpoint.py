"""Checkpoint / restart of the port, in the reference's on-disk layout
(``train/checkpoint.py``), so that a checkpoint written by either package
restores in the other:

    <dir>/step_<N>/
        manifest.json     step, time, process_count, device_count, leaves
                          [{name, shape, dtype}], extra
        <leaf_name>.npy   one array per leaf

Leaf names are the reference's ``tree_flatten_with_path`` names: a
NamedTuple field ``f`` is ``.f``, a dict key its own string, joined by
``__`` (``.params__layers__wq``, ``.opt__.step``, ``.opt__.mu__embed``), in
the reference's order (fields in order, dict keys sorted).  The port's
parameter dicts are keyed by state-dict name (``layers.wq``): each ``.``
is a level of the reference's tree.  bf16 leaves are written as the
reference writes them, numpy's ``<V2`` descriptor over the raw 2-byte
payload, and read back by that payload, so no ``ml_dtypes`` is needed on
either side.

Restores copy into the target tree's own tensors (a ``TrainState`` built on
the model's parameters stays the model's): shapes must match, the file's
values are cast to the target's dtype.

On a device mesh a DTensor leaf is saved whole (``full_tensor()``, a
collective every rank joins; the first rank writes), so the files are the
single-process layout whatever the mesh; the manifest then records the
saver's mesh shape and axis names (``mesh``; a tree with no DTensor leaf
writes the reference's keys alone).  Restores are
elastic: a DTensor target leaf takes its own shard of the file's value, on
its own mesh and placements, which may differ from the saver's (another
mesh shape, another device count, or no mesh at all).  ``shardings``, the
reference's argument, states those placements (a tree like the target's
with :class:`sharding.Placed` leaves, as ``step.state_shardings`` builds
one) and is held to the target's.  ``latest_step`` / ``_gc`` give
crash-restart semantics; ``EmergencySaver`` flushes a checkpoint after a
SIGTERM.
"""

from __future__ import annotations

import json
import os
import shutil
import signal
import time
from typing import Any, Callable, Dict, List, Optional, Tuple

import numpy as np
import torch
import torch.distributed as dist
from torch.distributed.tensor import DTensor, distribute_tensor

from repro_torch.train.sharding import Placed

_NPY_BF16 = "<V2"  # what numpy writes for ml_dtypes' bfloat16


def _flatten(tree: Any, path: Tuple[str, ...] = ()) -> List[Tuple[str, Any]]:
    """(name, leaf) leaves of ``tree`` in the reference's order; a leaf is
    a tensor (or a ``Placed`` of a shardings tree)."""
    if tree is None:
        return []
    if isinstance(tree, (torch.Tensor, Placed)):
        return [("__".join(path), tree)]
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return [leaf for f in tree._fields
                for leaf in _flatten(getattr(tree, f), path + (f".{f}",))]
    if isinstance(tree, dict):
        keyed = sorted((tuple(str(k).split(".")), v) for k, v in tree.items())
        return [leaf for k, v in keyed for leaf in _flatten(v, path + k)]
    raise TypeError(f"cannot checkpoint a {type(tree).__name__} at {'__'.join(path)}")


def _save_leaf(path: str, t: torch.Tensor) -> Tuple[List[int], str]:
    t = t.detach().cpu().contiguous()
    if t.dtype == torch.bfloat16:
        bits = t.view(torch.int16).numpy().view(np.uint16)
        with open(path, "wb") as f:
            np.lib.format.write_array_header_1_0(
                f, {"descr": _NPY_BF16, "fortran_order": False, "shape": tuple(t.shape)})
            f.write(bits.astype("<u2").tobytes())
        return list(t.shape), "bfloat16"
    arr = t.numpy()
    np.save(path, arr)
    return list(arr.shape), str(arr.dtype)


def _load_leaf(path: str) -> torch.Tensor:
    arr = np.load(path)
    if arr.dtype.kind == "V" and arr.dtype.itemsize == 2:  # bfloat16
        return torch.from_numpy(np.require(arr, requirements="C").view("<i2")).view(torch.bfloat16)
    return torch.from_numpy(np.require(arr, requirements="C"))


def _topology() -> Tuple[int, int]:
    procs = dist.get_world_size() if dist.is_available() and dist.is_initialized() else 1
    return procs, torch.cuda.device_count()


def _writer() -> bool:
    """Whether this process writes: the first rank, or the only process."""
    return not (dist.is_available() and dist.is_initialized()) or dist.get_rank() == 0


def save(ckpt_dir: str, step: int, tree: Any, *, extra: Optional[Dict] = None,
         keep: int = 3) -> str:
    """Atomically write checkpoint ``step``; garbage-collect old ones.  With
    DTensor leaves every rank of their mesh calls it (each leaf is gathered
    whole), the first rank writes, and all return once it has."""
    out = os.path.join(ckpt_dir, f"step_{step:08d}")
    tmp = out + ".tmp"
    writer = _writer()
    if writer:
        os.makedirs(tmp, exist_ok=True)
    procs, devices = _topology()
    leaves = _flatten(tree)
    meshes = [leaf.device_mesh for _, leaf in leaves if isinstance(leaf, DTensor)]
    manifest = {"step": step, "time": time.time(), "process_count": procs,
                "device_count": devices, "leaves": [], "extra": extra or {}}
    if meshes:
        manifest["mesh"] = {"shape": list(meshes[0].shape),
                            "axis_names": list(meshes[0].mesh_dim_names or ())}
    for name, leaf in leaves:
        if isinstance(leaf, DTensor):
            leaf = leaf.full_tensor()
        if not writer:
            continue
        shape, dtype = _save_leaf(os.path.join(tmp, name + ".npy"), leaf)
        manifest["leaves"].append({"name": name, "shape": shape, "dtype": dtype})
    if writer:
        with open(os.path.join(tmp, "manifest.json"), "w") as f:
            json.dump(manifest, f, indent=1)
        if os.path.exists(out):
            shutil.rmtree(out)
        os.rename(tmp, out)
        _gc(ckpt_dir, keep)
    if meshes and dist.is_initialized():
        dist.barrier()
    return out


def _gc(ckpt_dir: str, keep: int):
    steps = sorted(d for d in os.listdir(ckpt_dir) if d.startswith("step_"))
    for d in steps[:-keep] if keep > 0 else []:
        shutil.rmtree(os.path.join(ckpt_dir, d), ignore_errors=True)


def latest_step(ckpt_dir: str) -> Optional[int]:
    if not os.path.isdir(ckpt_dir):
        return None
    steps = [int(d.split("_")[1]) for d in os.listdir(ckpt_dir)
             if d.startswith("step_") and not d.endswith(".tmp")]
    return max(steps) if steps else None


@torch.no_grad()
def restore(ckpt_dir: str, step: int, target_tree: Any, shardings: Optional[Any] = None):
    """Load checkpoint ``step`` into the tensors of ``target_tree`` (in
    place; the target's devices, dtypes and, for DTensor leaves, meshes and
    placements: each rank keeps its shard).  ``shardings``, when given, is
    a tree like the target's with a ``Placed`` (or None) per leaf, and each
    must be its target leaf's mesh and placements.  Returns (target_tree,
    extra)."""
    src = os.path.join(ckpt_dir, f"step_{step:08d}")
    with open(os.path.join(src, "manifest.json")) as f:
        manifest = json.load(f)
    by_name = {leaf["name"] for leaf in manifest["leaves"]}
    placed = dict(_flatten(shardings)) if shardings is not None else {}
    loaded = []
    for name, leaf in _flatten(target_tree):
        if name not in by_name:
            raise KeyError(f"checkpoint missing leaf {name}")
        want = placed.get(name)
        if want is not None and not (isinstance(leaf, DTensor) and leaf.device_mesh == want.mesh
                                     and tuple(leaf.placements) == tuple(want.placements)):
            got = (leaf.device_mesh, leaf.placements) if isinstance(leaf, DTensor) else "no mesh"
            raise ValueError(f"leaf {name}: shardings ask for {want}, the target is on {got}")
        arr = _load_leaf(os.path.join(src, name + ".npy"))
        if tuple(arr.shape) != tuple(leaf.shape):
            raise ValueError(f"leaf {name}: checkpoint shape {tuple(arr.shape)} "
                             f"!= target {tuple(leaf.shape)}")
        loaded.append((leaf, arr))
    for leaf, arr in loaded:
        if isinstance(leaf, DTensor):
            arr = distribute_tensor(arr.to(leaf.device, leaf.dtype), leaf.device_mesh,
                                    leaf.placements, src_data_rank=None)
            leaf.to_local().copy_(arr.to_local())
        else:
            leaf.copy_(arr)
    return target_tree, manifest["extra"]


class EmergencySaver:
    """SIGTERM-triggered flush: preemption-safe checkpointing.

    Register once; call ``maybe_save(step, tree)`` at step boundaries — if a
    signal arrived since the last call, a checkpoint is written immediately.
    """

    def __init__(self, ckpt_dir: str, extra_fn: Optional[Callable[[], Dict]] = None):
        self.ckpt_dir = ckpt_dir
        self.extra_fn = extra_fn
        self.triggered = False
        self._prev = signal.signal(signal.SIGTERM, self._on_signal)

    def _on_signal(self, signum, frame):
        self.triggered = True

    def maybe_save(self, step: int, tree: Any) -> bool:
        if not self.triggered:
            return False
        save(self.ckpt_dir, step, tree,
             extra=(self.extra_fn() if self.extra_fn else {"emergency": True}))
        self.triggered = False
        return True

    def close(self):
        signal.signal(signal.SIGTERM, self._prev)
