"""Carry tables and model weights across from host numpy arrays.

Data takes the place of weights in this system.  A table of the JAX package
is handed over as plain numpy arrays (this module imports nothing of that
package): a mapping with ``columns`` (name → 1-D array), ``valid``,
``block_id``, ``block_rows``, ``num_rows`` and ``num_origin_blocks``.  The
arrays are copied byte for byte, in their dtypes, onto ``device``.  A
model's parameter tree comes over the same way
(:func:`model_params_from_arrays`), so both packages compute with the same
weights, and so does a decode cache (:func:`cache_from_arrays`), so both
can decode from one prefilled state.
"""

from __future__ import annotations

from typing import Any, Dict, Mapping

import numpy as np
import torch

from repro_torch.device import resolve_device
from repro_torch.engine.table import BlockTable
from repro_torch.models.model import cache_spec, layer_shapes

_DTYPES = {np.dtype(np.float32), np.dtype(np.int32), np.dtype(np.bool_)}


def _tensor(a, what: str, dev: torch.device) -> torch.Tensor:
    arr = np.ascontiguousarray(np.asarray(a))
    if arr.ndim != 1 or arr.dtype not in _DTYPES:
        raise ValueError(f"{what}: expected a 1-D float32/int32/bool array, "
                         f"got {arr.dtype} of shape {arr.shape}")
    return torch.from_numpy(arr.copy()).to(dev)


def table_from_arrays(name: str, arrays: Mapping, device="cuda") -> BlockTable:
    """One table from its arrays (see the module docstring for the keys)."""
    dev = resolve_device(device)
    return BlockTable(
        name=name,
        columns={c: _tensor(v, f"{name}.{c}", dev)
                 for c, v in arrays["columns"].items()},
        block_rows=int(arrays["block_rows"]),
        num_rows=int(arrays["num_rows"]),
        valid=_tensor(arrays["valid"], f"{name}.valid", dev),
        block_id=_tensor(arrays["block_id"], f"{name}.block_id", dev),
        num_origin_blocks=int(arrays["num_origin_blocks"]),
    )


def catalog_from_arrays(tables: Mapping[str, Mapping],
                        device="cuda") -> Dict[str, BlockTable]:
    """A catalog (name → BlockTable) on ``device`` from each table's arrays."""
    return {name: table_from_arrays(name, arrays, device)
            for name, arrays in tables.items()}


def _weight(a, what: str, dev: torch.device) -> torch.Tensor:
    arr = np.ascontiguousarray(np.asarray(a))
    if arr.dtype.name == "bfloat16":  # ml_dtypes' bfloat16: carry the bits
        return torch.from_numpy(arr.view(np.uint16).copy()).view(torch.bfloat16).to(dev)
    if arr.dtype != np.dtype(np.float32):
        raise ValueError(f"{what}: expected a float32/bfloat16 array, got {arr.dtype}")
    return torch.from_numpy(arr.copy()).to(dev)


def model_params_from_arrays(cfg, params: Mapping[str, Any],
                             device="cuda") -> Dict[str, torch.Tensor]:
    """The reference's parameter tree of ``cfg`` as the port's state dict.

    ``params`` holds numpy arrays (bfloat16 ones as ml_dtypes arrays):
    ``embed``, ``final_norm``, ``head`` and ``layers`` (name → array with the
    layers stacked on a leading L axis, the reference's ``scan_layers=True``
    layout).  Returns tensors on ``device`` keyed as
    ``repro_torch.models.Model``'s ``state_dict``, bits unchanged; load them
    with ``model.load_state_dict``.
    """
    dev = resolve_device(device)
    out = {name: _weight(params[name], name, dev)
           for name in ("embed", "final_norm", "head")}
    shapes = layer_shapes(cfg)
    missing = sorted(set(shapes) - set(params["layers"]))
    if missing:
        raise ValueError(f"{cfg.name}: layer parameters missing: {missing}")
    for name, a in params["layers"].items():
        t = _weight(a, f"layers.{name}", dev)
        want = (cfg.num_layers, *shapes.get(name, t.shape[1:]))
        if tuple(t.shape) != want:
            raise ValueError(f"layers.{name}: expected shape {want} (layers "
                             f"stacked on axis 0), got {tuple(t.shape)}")
        out[f"layers.{name}"] = t
    return out


def cache_from_arrays(cfg, cache: Mapping[str, Any],
                      device="cuda") -> Dict[str, torch.Tensor]:
    """The reference's decode cache of ``cfg`` (numpy arrays keyed as its
    ``Model.cache_spec``: ``pos``, and ``k`` / ``v`` / ``ssm`` as the family
    has them) as the port's, bits unchanged, on ``device``."""
    dev = resolve_device(device)
    pos = np.asarray(cache["pos"])
    ring = np.asarray(cache["k"]).shape[3] if cfg.has_attention else 1
    spec = cache_spec(cfg, pos.shape[0], ring)
    if set(cache) != set(spec):
        raise ValueError(f"cache keys {sorted(cache)}, expected {sorted(spec)}")
    out = {}
    for name, (shape, dt) in spec.items():
        arr = np.ascontiguousarray(np.asarray(cache[name]))
        if name == "pos" and arr.dtype == np.int32:
            t = torch.from_numpy(arr.copy()).to(dev)
        elif name == "pos":
            raise ValueError(f"cache pos: expected int32, got {arr.dtype}")
        else:
            t = _weight(arr, name, dev)
        if tuple(t.shape) != shape or t.dtype != dt:
            raise ValueError(f"cache {name}: expected {shape} {dt}, got "
                             f"{tuple(t.shape)} {t.dtype}")
        out[name] = t
    return out
