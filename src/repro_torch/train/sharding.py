"""Sharding policy of the port: FSDP over the data axes x TP over the model
axis, the reference's ``train/sharding.py`` rules on a torch
``DeviceMesh`` with DTensor placements.

Rules (path-name driven, uniform across the ten architectures):

* 2-D projections: input-feature dim -> FSDP axes, output-feature dim -> TP
  (``wq/wk/wv/w1/w3/router`` and the SSM projections); reversed for the
  output projections (``wo/w2/s_wo/xwo``).  The stacked leading L axis is
  unsharded.
* MoE experts: expert dim -> TP (expert parallelism); the d_model dim -> FSDP.
* Embedding / head: d_model -> TP when it divides, vocab unsharded.
* Norm scales and ``s_gbias``: replicated.  ``FSDP_MIN_SIZE`` is the
  reference's constant; as there, no rule reads it.
* Optimizer state mirrors the parameters leaf for leaf.

Activations: batch -> data axes.  Decode caches (L, B, kvH, S, hd): batch ->
data, seq -> TP; the SSM state's heads -> TP.

A spec is a plain tuple with one entry per tensor dim: ``None``, an axis
name, or a tuple of names (the reference's ``PartitionSpec`` in plain
Python, so the two compare entry for entry); ``placements`` turns it into
one DTensor placement per mesh dim.  The rules read only the mesh's axis
names and sizes, so they take a ``DeviceMesh`` or a :class:`MeshShape`
stand-in that needs no process group.  Parameter paths are the reference's
(``layers/wq``); the port's state-dict names (``layers.wq``) map onto them
one ``.`` to one ``/``, as ``convert.py`` maps them.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, List, Mapping, Optional, Tuple, Union

from torch import nn
from torch.distributed.tensor import DTensor, Placement, Replicate, Shard, distribute_tensor

FSDP_MIN_SIZE = 2**16  # leave tiny tensors replicated

Entry = Union[None, str, Tuple[str, ...]]
Spec = Tuple[Entry, ...]


@dataclasses.dataclass(frozen=True)
class MeshShape:
    """A mesh's sizes and axis names, without devices or a process group:
    what the rules read of a ``DeviceMesh``."""

    shape: Tuple[int, ...]
    axis_names: Tuple[str, ...]


@dataclasses.dataclass(frozen=True)
class Placed:
    """A leaf's place on a mesh: a leaf of a shardings tree
    (``checkpoint.restore``)."""

    mesh: Any
    placements: Tuple[Placement, ...]


def axis_names(mesh) -> Tuple[str, ...]:
    names = getattr(mesh, "mesh_dim_names", None)
    return tuple(names if names is not None else mesh.axis_names)


def axis_sizes(mesh) -> Dict[str, int]:
    return dict(zip(axis_names(mesh), tuple(mesh.shape)))


def data_axes(mesh) -> Tuple[str, ...]:
    return tuple(a for a in ("pod", "data") if a in axis_names(mesh))


def tp_axis(mesh) -> Optional[str]:
    return "model" if "model" in axis_names(mesh) else None


def _divisible(dim: int, mesh, axes) -> bool:
    if not axes:
        return False
    sizes = axis_sizes(mesh)
    total = 1
    for a in (axes if isinstance(axes, tuple) else (axes,)):
        total *= sizes[a]
    return dim % total == 0 and dim >= total


def param_pspec(path: str, shape: Tuple[int, ...], mesh, scan_layers: bool = True) -> Spec:
    """The spec of the parameter at ``path`` (``layers/wq``) of ``shape``."""
    fsdp = data_axes(mesh)
    tp = tp_axis(mesh)
    name = path.split("/")[-1]

    if name in ("embed", "head"):
        # shard d_model, not vocab: token gathers stay shard-local
        return (None, tp) if _divisible(shape[1], mesh, tp) else (None, None)
    if name in ("final_norm", "enc_norm") or name.startswith("ln") or name == "s_gbias":
        return (None,) * len(shape)

    # stacked layer arrays: strip the leading L axis from the rule
    lead: Spec = (None,) if scan_layers else ()
    core = shape[1:] if scan_layers else shape

    if name in ("e_w1", "e_w3"):           # (E, D, F): EP x FSDP
        ep = tp if _divisible(core[0], mesh, tp) else None
        fs = fsdp if _divisible(core[1], mesh, fsdp) else None
        return lead + (ep, fs, None)
    if name == "e_w2":                      # (E, F, D)
        ep = tp if _divisible(core[0], mesh, tp) else None
        fs = fsdp if _divisible(core[2], mesh, fsdp) else None
        return lead + (ep, None, fs)
    if len(core) == 2:
        d_in, d_out = core
        if name in ("wo", "w2", "s_wo", "xwo"):
            a = tp if _divisible(d_in, mesh, tp) else None
            b = fsdp if _divisible(d_out, mesh, fsdp) else None
            return lead + (a, b)
        # default: in -> FSDP, out -> TP
        a = fsdp if _divisible(d_in, mesh, fsdp) else None
        b = tp if _divisible(d_out, mesh, tp) else None
        return lead + (a, b)
    return (None,) * len(shape)


def _shape_of(leaf) -> Tuple[int, ...]:
    """A tensor's shape, a ``(shape, dtype)`` spec's (``launch.specs``), or
    a shape itself."""
    if hasattr(leaf, "shape"):
        return tuple(leaf.shape)
    if leaf and isinstance(leaf[0], (tuple, list)):
        return tuple(leaf[0])
    return tuple(leaf)


def params_pspecs(params: Mapping[str, Any], mesh, scan_layers: bool = True) -> Dict[str, Spec]:
    """Specs of a state-dict-keyed parameter mapping (tensors, specs or
    shapes), by the reference's path of each name."""
    return {n: param_pspec(n.replace(".", "/"), _shape_of(p), mesh, scan_layers)
            for n, p in params.items()}


def placements(spec: Spec, mesh) -> List[Placement]:
    """One DTensor placement per mesh dim: ``Shard(d)`` where tensor dim d's
    entry names that axis, else ``Replicate()``.  A tuple entry shards one
    tensor dim over several mesh dims, the first named the major one (the
    mesh's own order).  A mesh dim of size 1 replicates: its one shard is
    the whole dim, and DTensor would refuse to drop a size-1 dim it calls
    sharded."""
    names, sizes = axis_names(mesh), tuple(mesh.shape)
    out: List[Placement] = [Replicate()] * len(names)
    for d, entry in enumerate(spec):
        axes = () if entry is None else (entry if isinstance(entry, tuple) else (entry,))
        at = [names.index(a) for a in axes]
        if at != sorted(at):
            raise ValueError(f"spec entry {entry} runs against the mesh's axis order {names}")
        for i in at:
            if sizes[i] > 1:
                out[i] = Shard(d)
    return out


def params_shardings(model: nn.Module, mesh, scan_layers: bool = True) -> Dict[str, List[Placement]]:
    """Each ``named_parameters()`` leaf's placements on ``mesh``."""
    specs = params_pspecs(dict(model.named_parameters()), mesh, scan_layers)
    return {n: placements(s, mesh) for n, s in specs.items()}


def shard_model(model: nn.Module, mesh, scan_layers: bool = True) -> nn.Module:
    """Replaces every parameter of ``model`` by a DTensor on ``mesh`` with
    ``params_shardings``' placements, in place.  Each rank keeps its own
    shard of its own copy (``src_data_rank=None``: no communication), so
    every rank must hold the same values, as seeded weights are."""
    shardings = params_shardings(model, mesh, scan_layers)
    for name, p in list(model.named_parameters()):
        owner_name, _, leaf = name.rpartition(".")
        owner = model.get_submodule(owner_name) if owner_name else model
        d = distribute_tensor(p.detach(), mesh, shardings[name], src_data_rank=None)
        setattr(owner, leaf, nn.Parameter(d, requires_grad=p.requires_grad))
    return model


# -- activations / batches ----------------------------------------------------

def batch_pspec(mesh, batch_size: int) -> Spec:
    dp = data_axes(mesh)
    if _divisible(batch_size, mesh, dp):
        return (dp,)
    # small batches (e.g. long_500k's batch=1): replicate over data
    return (None,)


def batch_pspecs(batch: Mapping[str, Any], mesh) -> Dict[str, Spec]:
    """Each batch leaf's spec: its leading dim by ``batch_pspec``."""
    def leaf_spec(leaf):
        shape = _shape_of(leaf)
        return batch_pspec(mesh, shape[0]) + (None,) * (len(shape) - 1)

    return {n: leaf_spec(v) for n, v in batch.items()}


def place_batch(batch: Mapping[str, Any], mesh) -> Dict[str, Any]:
    """A plain global batch as DTensors on ``mesh``, placed by
    ``batch_pspecs``: each rank keeps its own rows, with no communication
    (every rank must hold the same batch).  DTensor leaves stay as they are."""
    specs = batch_pspecs(batch, mesh)
    return {k: v if isinstance(v, DTensor) else
            distribute_tensor(v, mesh, placements(specs[k], mesh), src_data_rank=None)
            for k, v in batch.items()}


def cache_pspecs(cache: Mapping[str, Any], mesh) -> Dict[str, Spec]:
    """Decode-cache specs: (L, B, kvH, S, hd) batch -> data, seq -> TP; the
    SSM state (L, B, H, dk, dv) batch -> data, heads -> TP; ``pos``
    replicated."""
    dp = data_axes(mesh)
    tp = tp_axis(mesh)

    def leaf_spec(name, shape):
        if name == "pos":
            return ()
        if name in ("k", "v", "cross_k", "cross_v"):
            _, b, _, s, _ = shape
            return (None, dp if _divisible(b, mesh, dp) else None, None,
                    tp if _divisible(s, mesh, tp) else None, None)
        if name == "ssm":
            _, b, nh, _, _ = shape
            return (None, dp if _divisible(b, mesh, dp) else None,
                    tp if _divisible(nh, mesh, tp) else None, None, None)
        return (None,) * len(shape)

    return {n: leaf_spec(n, _shape_of(v)) for n, v in cache.items()}
