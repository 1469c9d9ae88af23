"""Columnar, block-structured tables over torch tensors on one device.

A :class:`BlockTable` is the analogue of a DBMS heap file: every column is
one contiguous 1-D tensor of length ``num_blocks * block_rows`` and a *block*
— the paper's "minimum unit of data accessing in the storage layer" — is a
contiguous ``block_rows`` slab of every column.  Block sampling touches only
the sampled slabs (the kernels read them by block id), while an exact scan
streams every slab.

Rows carry two pieces of lineage that BSAP needs:

* ``valid``    — row liveness (bool; padding rows are invalid),
* ``block_id`` — the *origin* block index in the base table (int32), which
                 relational operators preserve (Props. 4.4–4.6).

All tensors of a table live on one device; ``row_bytes`` / ``total_bytes``
count the columns only, in their stored dtypes, exactly like the reference.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional

import numpy as np
import torch

from repro_torch.device import resolve_device


@dataclasses.dataclass
class BlockTable:
    """A columnar table with a fixed physical block size."""

    name: str
    columns: Dict[str, torch.Tensor]  # each shape (num_blocks * block_rows,)
    block_rows: int
    num_rows: int  # logical rows (<= padded length)
    valid: Optional[torch.Tensor] = None  # bool, same shape as columns
    block_id: Optional[torch.Tensor] = None  # int32 origin block per row
    num_origin_blocks: Optional[int] = None  # blocks in the *base* table

    def __post_init__(self):
        n = self.padded_rows
        dev = self.device
        for cname, col in self.columns.items():
            if tuple(col.shape) != (n,):
                raise ValueError(
                    f"column {cname!r} has shape {tuple(col.shape)}, expected ({n},)")
            if col.device != dev:
                raise ValueError(
                    f"column {cname!r} is on {col.device}, table on {dev}")
        if self.valid is None:
            valid = torch.zeros(n, dtype=torch.bool, device=dev)
            valid[: self.num_rows] = True
            self.valid = valid
        if self.block_id is None:
            self.block_id = torch.arange(
                self.num_blocks, dtype=torch.int32, device=dev
            ).repeat_interleave(self.block_rows)
        if self.num_origin_blocks is None:
            self.num_origin_blocks = self.num_blocks
        for what, t, dt in (("valid", self.valid, torch.bool),
                            ("block_id", self.block_id, torch.int32)):
            if tuple(t.shape) != (n,) or t.dtype != dt or t.device != dev:
                raise ValueError(
                    f"{what} must be {dt} of shape ({n},) on {dev}, got "
                    f"{t.dtype} {tuple(t.shape)} on {t.device}")

    # -- geometry ----------------------------------------------------------
    @property
    def padded_rows(self) -> int:
        some = next(iter(self.columns.values()))
        return int(some.shape[0])

    @property
    def num_blocks(self) -> int:
        return self.padded_rows // self.block_rows

    @property
    def device(self) -> torch.device:
        return next(iter(self.columns.values())).device

    def row_bytes(self) -> int:
        return sum(int(c.element_size()) for c in self.columns.values())

    def total_bytes(self) -> int:
        return self.row_bytes() * self.padded_rows

    # -- constructors --------------------------------------------------------
    @staticmethod
    def from_numpy(name: str, columns: Dict[str, np.ndarray], block_rows: int,
                   device="cuda") -> "BlockTable":
        dev = resolve_device(device)
        num_rows = len(next(iter(columns.values())))
        pad = (-num_rows) % block_rows
        cols = {}
        for cname, col in columns.items():
            col = np.asarray(col)
            if pad:
                col = np.concatenate([col, np.zeros(pad, dtype=col.dtype)])
            cols[cname] = torch.from_numpy(np.ascontiguousarray(col)).to(dev)
        return BlockTable(name=name, columns=cols, block_rows=block_rows,
                          num_rows=num_rows)
