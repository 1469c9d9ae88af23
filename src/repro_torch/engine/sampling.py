"""Bernoulli block-sampling decisions (host numpy, as in the reference).

Sampling *decisions* are host-side (numpy RNG) — exactly as a DBMS's
TABLESAMPLE decides pages before scanning them — and data movement is
device-side: the kernels read only the sampled blocks (cost ∝ θ · bytes).

The draws are the reference's bit for bit (``rng.random(N) < rate`` under
``np.random.default_rng(seed)``, over blocks for TABLESAMPLE SYSTEM and over
every padded row for TABLESAMPLE BERNOULLI), so equal seeds give equal block
ids and row masks in both packages.  The distributed sub-draw
(``restrict_block_ids``) and the staged one (``subdraw_positions``) are
restrictions of that one realization, so they draw the same blocks too.
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


def restrict_block_ids(ids: np.ndarray, lo: int, hi: int) -> np.ndarray:
    """Restrict a drawn block-id set to the range ``[lo, hi)``, re-based.

    The distributed TABLESAMPLE sub-draw (``repro_torch.dist``): every shard
    computes the SAME global realization from the shared content-derived
    seed and keeps its own block range, so the union of the per-shard
    sub-draws is the monolithic draw bit for bit (independent per-shard
    seeds would give another realization per shard count).
    """
    ids = np.asarray(ids)
    return (ids[(ids >= lo) & (ids < hi)] - lo).astype(np.int32)


def subdraw_positions(rung_ids: np.ndarray, num_blocks: int, rate: float,
                      seed: int) -> tuple[np.ndarray, np.ndarray]:
    """Sub-draw at ``rate`` from a staged rung drawn at a rate >= ``rate``
    with the SAME seed: ``(sub_ids, positions)``.

    Under the one-uniform-vector draw (``rng.random(N) < rate``) every block
    kept at rate r is kept at any R >= r under the same seed, so ``sub_ids``
    (the fresh draw at ``rate``) is a subset of ``rung_ids`` and
    ``positions`` (both ascending, so ``searchsorted`` is exact) addresses
    each sub-drawn block within the rung (``repro_torch.engine.staged``).
    """
    sub_ids = draw_block_ids(num_blocks, rate, seed)
    positions = np.searchsorted(np.asarray(rung_ids), sub_ids).astype(np.int32)
    return sub_ids, positions


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
