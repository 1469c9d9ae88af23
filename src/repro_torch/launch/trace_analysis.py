"""Per-device FLOPs, HBM bytes and collective wire bytes of a traced step:
the port's counterpart of the reference's ``launch/hlo_analysis.py``.

There is no HLO in the port: the step runs op by op (eagerly on the card,
or under ``FakeTensorMode`` in the dry run, where no op computes anything).
:class:`TraceAnalysis` is a ``TorchDispatchMode`` that sees the ops each rank
runs on its own tensors: it steps aside for DTensor (returns
``NotImplemented``), so DTensor dispatches, redistributes and runs each op
on the local shards, and those local ops, the collectives among them, come
back through the mode.  Counting there gives one device's numbers, where a
``FlopCounterMode`` entered above DTensor counts the global shapes.  The
ops DTensor runs on global shapes to learn an output's shape (its sharding
propagation) are not counted.

Semantics, the reference's where they carry over:

* FLOPs: the product ops (``torch.utils.flop_counter``'s formulas: mm,
  addmm, bmm, baddbmm, convolutions, SDPA) and the port's custom kernels
  (the flash and GLA operators register their own); elementwise ops are not
  counted (the roofline's MODEL/HLO ratio reports the gap).
* HBM bytes: input plus output bytes of every op that is not a view or an
  allocation (eager PyTorch fuses nothing, so every op reads and writes
  device memory); an in-place op counts its other inputs only, the
  reference's rule for an aliased update.
* Collective wire bytes per device, ring formulas with n the group size:
  all-gather out (n-1)/n, reduce-scatter in (n-1)/n, all-reduce 2 in
  (n-1)/n, all-to-all in (n-1)/n; counted under the reference's names,
  in all and by kind.  An all-to-all counts as one wherever the caller
  issues the functional op (the MoE route does, on any group); DTensor's
  own shard-to-shard moves on a CPU mesh fall back to an all-gather and
  count as that.
"""

from __future__ import annotations

import sys
from typing import Any, Dict

import torch
from torch.distributed.tensor import DTensor
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_flatten
from torch.utils.flop_counter import flop_registry

_c10d = torch.ops._c10d_functional
# op -> (reference's name, wire bytes per device from (in, out, n))
_COLLECTIVES = {
    _c10d.all_gather_into_tensor.default: ("all-gather", lambda i, o, n: o * (n - 1) / n),
    _c10d.reduce_scatter_tensor.default: ("reduce-scatter", lambda i, o, n: i * (n - 1) / n),
    _c10d.all_reduce.default: ("all-reduce", lambda i, o, n: 2.0 * i * (n - 1) / n),
    _c10d.all_reduce_.default: ("all-reduce", lambda i, o, n: 2.0 * i * (n - 1) / n),
    _c10d.all_to_all_single.default: ("all-to-all", lambda i, o, n: i * (n - 1) / n),
}
# ops that move no device bytes of their own
_NO_BYTES = {
    torch.ops.aten.empty.memory_format, torch.ops.aten.empty_strided.default,
    torch.ops.aten.empty_like.default, torch.ops.aten.new_empty.default,
    torch.ops.aten.new_empty_strided.default, torch.ops.aten.detach.default,
    torch.ops.aten.lift_fresh.default, torch.ops.aten._local_scalar_dense.default,
    torch.ops.prim.device.default, _c10d.wait_tensor.default,
}
_PROPAGATION_FILE = "_sharding_prop.py"


def _tensors(tree):
    return [t for t in tree_flatten(tree)[0] if isinstance(t, torch.Tensor)]


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


def in_sharding_propagation() -> bool:
    """Whether the caller runs inside DTensor's sharding propagation (its
    global-shape shape inference), by the frames on the stack."""
    f = sys._getframe(2)
    while f is not None:
        if f.f_code.co_filename.endswith(_PROPAGATION_FILE):
            return True
        f = f.f_back
    return False


def group_size(func, args) -> int:
    """A functional collective's group size: its ``group_size`` argument,
    or its group's, resolved by name."""
    for a, schema_arg in zip(args, func._schema.arguments):
        if schema_arg.name == "group_size":
            return int(a)
    name = next(a for a, s in zip(args, func._schema.arguments) if s.name == "group_name")
    from torch.distributed.distributed_c10d import _resolve_process_group

    return _resolve_process_group(name).size()


class TraceAnalysis(TorchDispatchMode):
    """Counts, per device, the ops run under it (see the module's doc);
    ``result()`` gives the reference's keys.  ``num_partitions`` is the
    mesh size, recorded as given."""

    def __init__(self, num_partitions: int = 1):
        super().__init__()
        self.num_partitions = num_partitions
        self.flops = 0.0
        self.hbm_bytes = 0.0
        self.coll_bytes = 0.0
        self.coll_counts: Dict[str, int] = {}
        self.coll_bytes_by_kind: Dict[str, float] = {}

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        if any(issubclass(t, DTensor) for t in types):
            return NotImplemented
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        if not in_sharding_propagation():
            self._count(func, args, kwargs, out)
        return out

    def _count(self, func, args, kwargs, out) -> None:
        formula = flop_registry.get(func._overloadpacket)
        if formula is not None:
            self.flops += float(formula(*args, **kwargs, out_val=out))
        if func in _COLLECTIVES:
            name, wire = _COLLECTIVES[func]
            n = max(group_size(func, args), 1)
            i = sum(_nbytes(t) for t in _tensors(args[:1]))
            o = sum(_nbytes(t) for t in _tensors(out))
            self.coll_bytes += wire(i, o, n)
            self.coll_counts[name] = self.coll_counts.get(name, 0) + 1
            self.coll_bytes_by_kind[name] = self.coll_bytes_by_kind.get(name, 0.0) + wire(i, o, n)
        if func in _NO_BYTES or func.is_view:
            return
        schema = func._schema
        mutated = {i for i, a in enumerate(schema.arguments)
                   if a.alias_info is not None and a.alias_info.is_write}
        ins = [t for i, a in enumerate(args) if i not in mutated for t in _tensors(a)]
        ins += [t for k, v in kwargs.items() for t in _tensors(v)
                if not any(a.name == k and a.alias_info is not None and a.alias_info.is_write
                           for a in schema.arguments)]
        self.hbm_bytes += sum(_nbytes(t) for t in ins)
        if not mutated:
            self.hbm_bytes += sum(_nbytes(t) for t in _tensors(out))

    def result(self) -> Dict[str, Any]:
        return {"flops_per_device": self.flops,
                "hbm_bytes_per_device": self.hbm_bytes,
                "collective_bytes_per_device": self.coll_bytes,
                "collective_counts": dict(self.coll_counts),
                "collective_bytes_by_kind": dict(self.coll_bytes_by_kind),
                "num_partitions": self.num_partitions}
