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

    @property
    def column_names(self):
        return list(self.columns.keys())

    def row_bytes(self) -> int:
        return sum(int(c.element_size()) for c in self.columns.values())

    def total_bytes(self) -> int:
        return self.row_bytes() * self.padded_rows

    # -- derived tables -----------------------------------------------------
    def with_valid(self, valid: torch.Tensor) -> "BlockTable":
        return dataclasses.replace(self, valid=valid)

    def with_columns(self, columns: Dict[str, torch.Tensor]) -> "BlockTable":
        return dataclasses.replace(self, columns=columns)

    def gather_blocks(self, block_indices: np.ndarray) -> "BlockTable":
        """Materialize only the given blocks, on this table's device.

        The result re-labels physical blocks 0..k-1 but keeps ``block_id``
        pointing at the *origin* block indices, so BSAP statistics over it
        index the base table's block space.
        """
        idx = torch.as_tensor(np.asarray(block_indices, dtype=np.int64),
                              device=self.device)
        row_idx = (idx[:, None] * self.block_rows
                   + torch.arange(self.block_rows, device=self.device)[None, :]
                   ).reshape(-1)
        return BlockTable(
            name=self.name,
            columns={c: v[row_idx] for c, v in self.columns.items()},
            block_rows=self.block_rows,
            num_rows=int(row_idx.shape[0]),
            valid=self.valid[row_idx],
            block_id=self.block_id[row_idx],
            num_origin_blocks=self.num_origin_blocks,
        )

    def slice_blocks(self, lo: int, hi: int, device=None) -> "BlockTable":
        """Blocks ``[lo, hi)`` as a standalone table, ``block_id`` kept
        global: contiguous views of this table's tensors on its own device
        (the kernels read a view by its data pointer), copies on another
        ``device``."""
        dev = self.device if device is None else torch.device(device)
        br = self.block_rows
        piece = lambda t: t[lo * br:hi * br].to(dev)
        n_rows = min(hi * br, self.num_rows) - min(lo * br, self.num_rows)
        return BlockTable(
            name=self.name,
            columns={c: piece(v) for c, v in self.columns.items()},
            block_rows=br,
            num_rows=max(n_rows, 0),
            valid=piece(self.valid),
            block_id=piece(self.block_id),
            num_origin_blocks=self.num_origin_blocks,
        )

    def to(self, device) -> "BlockTable":
        """This table on ``device``: itself where it already lives there,
        else a copy of every tensor."""
        dev = torch.device(device)
        if dev.type == self.device.type and dev.index in (None, self.device.index):
            return self
        return BlockTable(
            name=self.name,
            columns={c: v.to(dev) for c, v in self.columns.items()},
            block_rows=self.block_rows,
            num_rows=self.num_rows,
            valid=self.valid.to(dev),
            block_id=self.block_id.to(dev),
            num_origin_blocks=self.num_origin_blocks,
        )

    def to_numpy(self) -> Dict[str, np.ndarray]:
        """Every column's valid rows, on the host, in their stored dtypes."""
        mask = self.valid.cpu().numpy()
        return {c: v.cpu().numpy()[mask] for c, v in self.columns.items()}

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
