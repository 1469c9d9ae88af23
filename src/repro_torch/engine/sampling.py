"""Bernoulli block-sampling decisions (host numpy, as in the reference).

Sampling *decisions* are host-side (numpy RNG) — exactly as a DBMS's
TABLESAMPLE decides pages before scanning them — and data movement is
device-side: the kernels read only the sampled blocks (cost ∝ θ · bytes).

The draws are the reference's bit for bit (``rng.random(N) < rate`` under
``np.random.default_rng(seed)``, over blocks for TABLESAMPLE SYSTEM and over
every padded row for TABLESAMPLE BERNOULLI), so equal seeds give equal block
ids and row masks in both packages.  The staged and distributed sub-draws
(``restrict_block_ids``, ``subdraw_positions``) wait for the slices that
port their consumers.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

from repro_torch.engine.table import BlockTable


@dataclasses.dataclass
class SampleInfo:
    method: str
    rate: float
    seed: int
    n_sampled_blocks: Optional[int] = None
    n_total_blocks: Optional[int] = None
    sampled_block_ids: Optional[np.ndarray] = None
    scanned_bytes: int = 0
    n_sampled_rows: Optional[int] = None  # row-Bernoulli kept rows
    n_total_rows: Optional[int] = None


def bucket_blocks(k: int) -> int:
    """Round the sampled-block count up to the next power of two (min 64).

    Sampled scans then recur in log-many physical shapes, the shapes the
    physical layer's signature cache keys on.  The <=2x overshoot is
    padding ids that re-point at block 0 and are masked out after the
    kernel; they are excluded from the scanned-bytes accounting."""
    if k <= 64:
        return 64
    return 1 << (k - 1).bit_length()


def draw_block_ids(num_blocks: int, rate: float, seed: int) -> np.ndarray:
    """The host-side Bernoulli block draw — the TABLESAMPLE SYSTEM decision."""
    rng = np.random.default_rng(seed)
    keep = rng.random(num_blocks) < rate
    return np.nonzero(keep)[0].astype(np.int32)


def pad_block_ids(ids: np.ndarray, num_blocks: int) -> tuple[np.ndarray, int, int]:
    """Zero-pad sampled ids to the bucketed physical count.

    Returns ``(phys_ids, n_real, n_phys)``; padding entries re-point at
    block 0 and must be masked out downstream (rows >= n_real).
    """
    n_real = int(len(ids))
    n_phys = min(bucket_blocks(max(n_real, 1)), num_blocks)
    pad = max(n_phys - n_real, 0)
    phys = np.concatenate([ids, np.zeros(pad, np.int32)]) if pad else ids
    return phys, n_real, n_phys


def draw_row_mask(padded_rows: int, rate: float, seed: int) -> np.ndarray:
    """The host-side Bernoulli row draw — the TABLESAMPLE BERNOULLI
    decision, one uniform per padded row."""
    rng = np.random.default_rng(seed)
    return rng.random(padded_rows) < rate


def draw_row_sample(table: BlockTable, rate: float,
                    seed: int) -> tuple[torch.Tensor, SampleInfo]:
    """One TABLESAMPLE BERNOULLI decision: the keep mask over every padded
    row, on the table's device, and its :class:`SampleInfo`, whose kept
    rows are counted on the device; the full scan is paid."""
    from repro_torch.engine.physical import scan_cost_bytes

    keep = torch.from_numpy(draw_row_mask(table.padded_rows, rate, seed)).to(table.device)
    info = SampleInfo("row", rate, seed, None, table.num_blocks, None,
                      scanned_bytes=scan_cost_bytes(table, "row"))
    info.n_sampled_rows = int((table.valid & keep).sum())
    info.n_total_rows = table.num_rows
    return keep, info


def row_sample(table: BlockTable, rate: float, seed: int) -> tuple[BlockTable, SampleInfo]:
    """TABLESAMPLE BERNOULLI analogue: the table with its validity cut by
    :func:`draw_row_sample`'s mask."""
    keep, info = draw_row_sample(table, rate, seed)
    return dataclasses.replace(table, valid=table.valid & keep), info
