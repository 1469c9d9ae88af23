"""Bernoulli block-sampling decisions: numpy's stream, on the host or on the
card.

Sampling *decisions* come before the scan — exactly as a DBMS's TABLESAMPLE
decides pages before scanning them — and data movement is device-side: the
kernels read only the sampled blocks (cost ∝ θ · bytes).

The draws are the reference's bit for bit (``rng.random(N) < rate`` under
``np.random.default_rng(seed)``, over blocks for TABLESAMPLE SYSTEM and over
every padded row for TABLESAMPLE BERNOULLI), so equal seeds give equal block
ids and row masks in both packages.  A compiled scan of a table on a CUDA
card draws there (:func:`draw_block_ids_device`: the ``block_draw`` kernel
makes the same PCG64 uniforms, and only the count comes back to the host
before the scan); ``executor.draw_blocks`` picks by the table's device.
The paths that need host
ids keep the host draw: the distributed sub-draw (``restrict_block_ids``)
and the staged one (``subdraw_positions``), restrictions of that one
realization, the fused path's check, the eager executor and the row draws.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

from repro_torch.engine import syncs
from repro_torch.engine.table import BlockTable
from repro_torch.kernels.block_draw import block_draw, pcg64_state
from repro_torch.obs import trace as _trace


@dataclasses.dataclass
class SampleInfo:
    method: str
    rate: float
    seed: int
    n_sampled_blocks: Optional[int] = None
    n_total_blocks: Optional[int] = None
    sampled_block_ids: Optional[np.ndarray] = None  # on the host; see settle()
    scanned_bytes: int = 0
    n_sampled_rows: Optional[int] = None  # row-Bernoulli kept rows
    n_total_rows: Optional[int] = None
    # a card's draw: its real ids on the card until settle() reads them
    # (BlockDraw.sample_info)
    pending_ids: Optional[torch.Tensor] = dataclasses.field(
        default=None, repr=False, compare=False)

    def settle(self) -> None:
        """Read ``sampled_block_ids`` from ``pending_ids``, in a
        ``host_read``.  The query's path calls this after the read of its
        sums, which waited for the stream, so the read waits for no queued
        work and the dispatch waited only for the draw's count."""
        if self.pending_ids is None:
            return
        with syncs.host_read(self.pending_ids):
            self.sampled_block_ids = self.pending_ids.cpu().numpy()
        self.pending_ids = None


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
    """The host-side Bernoulli block draw — the TABLESAMPLE SYSTEM decision —
    in a ``draw`` span whose ``where`` is "host"."""
    with _trace.span("draw", n_blocks=num_blocks, rate=rate, where="host") as sp:
        ids = _bernoulli_block_ids(num_blocks, rate, seed)
        sp.set(n_drawn=len(ids))
    return ids


def _bernoulli_block_ids(num_blocks: int, rate: float, seed: int) -> np.ndarray:
    """:func:`draw_block_ids` without its span, for a caller whose own
    ``draw`` span covers it (the staged sub-draw)."""
    rng = np.random.default_rng(seed)
    keep = rng.random(num_blocks) < rate
    return np.nonzero(keep)[0].astype(np.int32)


@dataclasses.dataclass
class BlockDraw:
    """One scan's block draw, padded to its bucketed length ``n_phys``
    (zeros past ``n_real``): the host's ``phys`` array with the ``ids`` it
    padded, or the card's ``ids_dev`` tensor."""

    n_real: int
    n_phys: int
    ids: Optional[np.ndarray] = None
    phys: Optional[np.ndarray] = None
    ids_dev: Optional[torch.Tensor] = None

    def sample_info(self, rate: float, seed: int, num_blocks: int,
                    scanned_bytes: int) -> SampleInfo:
        """The draw's :class:`SampleInfo`, whose ids are on the host so
        that what a caller keeps holds no memory of the card.  A card's
        real ids wait on the card: :meth:`SampleInfo.settle` reads them
        once the query's sums are read."""
        info = SampleInfo("block", rate, seed, self.n_real, num_blocks,
                          scanned_bytes=scanned_bytes)
        if self.ids_dev is None:
            info.sampled_block_ids = self.ids
        else:
            info.pending_ids = self.ids_dev[:self.n_real]
        return info


def draw_block_ids_device(num_blocks: int, rate: float, seed: int,
                          device) -> BlockDraw:
    """:func:`draw_block_ids` on the card, padded as :func:`pad_block_ids`
    pads it, in a ``draw`` span whose ``where`` is "device": the
    ``block_draw`` kernel, one 4-byte read of the count, and a copy of the
    first ``n_phys`` ids into a tensor of their own.  The ids are in range
    by construction, so no check of them is needed."""
    with _trace.span("draw", n_blocks=num_blocks, rate=rate, where="device") as sp:
        state, inc = pcg64_state(seed)
        count, out = block_draw(num_blocks, rate, state, inc, device)
        with syncs.host_read(count):
            n_real = int(count)
        n_phys = min(bucket_blocks(max(n_real, 1)), num_blocks)
        ids = out[:n_phys].clone()
        sp.set(n_drawn=n_real)
    return BlockDraw(n_real, n_phys, ids_dev=ids)


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
    sub_ids = _bernoulli_block_ids(num_blocks, rate, seed)
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


def block_sample(table: BlockTable, rate: float, seed: int) -> tuple[BlockTable, SampleInfo]:
    """TABLESAMPLE SYSTEM analogue for the eager executor: Bernoulli over
    blocks, the hit slabs gathered.

    The gathered table is padded to the bucketed block count with invalid
    copies of block 0 (they contribute nothing to any statistic and are not
    listed in ``sampled_block_ids``); ``scanned_bytes`` counts real blocks
    only."""
    from repro_torch.engine.physical import scan_cost_bytes

    ids = draw_block_ids(table.num_blocks, rate, seed)
    phys, n_real, _ = pad_block_ids(ids, table.num_blocks)
    sampled = table.gather_blocks(phys)
    if len(phys) > n_real:
        real = torch.arange(len(phys) * table.block_rows, device=table.device) \
            < n_real * table.block_rows
        sampled = dataclasses.replace(sampled, valid=sampled.valid & real)
    info = SampleInfo("block", rate, seed, n_real, table.num_blocks, ids,
                      scanned_bytes=scan_cost_bytes(table, "block", n_real))
    return sampled, info


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

    mask = draw_row_mask(table.padded_rows, rate, seed)
    with syncs.host_read(mask):
        keep = torch.from_numpy(mask).to(table.device)
    info = SampleInfo("row", rate, seed, None, table.num_blocks, None,
                      scanned_bytes=scan_cost_bytes(table, "row"))
    kept = (table.valid & keep).sum()
    with syncs.host_read(kept):
        info.n_sampled_rows = int(kept)
    info.n_total_rows = table.num_rows
    return keep, info


def row_sample(table: BlockTable, rate: float, seed: int) -> tuple[BlockTable, SampleInfo]:
    """TABLESAMPLE BERNOULLI analogue: the table with its validity cut by
    :func:`draw_row_sample`'s mask."""
    keep, info = draw_row_sample(table, rate, seed)
    return dataclasses.replace(table, valid=table.valid & keep), info
