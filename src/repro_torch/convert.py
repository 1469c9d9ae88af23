"""Carry tables across: host numpy arrays → the port's BlockTable catalog.

Data takes the place of weights in this system.  A table of the JAX package
is handed over as plain numpy arrays (this module imports nothing of that
package): a mapping with ``columns`` (name → 1-D array), ``valid``,
``block_id``, ``block_rows``, ``num_rows`` and ``num_origin_blocks``.  The
arrays are copied byte for byte, in their dtypes, onto ``device``.
"""

from __future__ import annotations

from typing import Dict, Mapping

import numpy as np
import torch

from repro_torch.device import resolve_device
from repro_torch.engine.table import BlockTable

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
