"""Bernoulli block-sampling decisions (host numpy, as in the reference).

Sampling *decisions* are host-side (numpy RNG) — exactly as a DBMS's
TABLESAMPLE decides pages before scanning them — and data movement is
device-side: the kernels read only the sampled blocks (cost ∝ θ · bytes).

The draw is the reference's bit for bit (``rng.random(N) < rate`` under
``np.random.default_rng(seed)``), so equal seeds give equal block ids in both
packages.  Row sampling and the staged / distributed sub-draws wait for later
slices of the port.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np


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
