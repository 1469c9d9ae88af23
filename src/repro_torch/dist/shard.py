"""Partitioned tables: disjoint block-range shards of a :class:`BlockTable`.

A :class:`ShardedTable` splits a block table into N contiguous block-range
partitions.  Blocks — the paper's minimum unit of data access — are the
atomic placement unit and are never split across shards, which is what makes
every per-block BSAP statistic *mergeable*: block sampling commutes with
selection / join / union (Props. 4.4-4.6), so pilot and final aggregation
state computed per shard combines by concatenation and summation without
weakening the a-priori error guarantees.

Placement.  As the reference places them (``jax.devices()`` round-robin):
with no devices named, a table on a CUDA card shards over every visible
card, shard i on ``cuda:{i % k}`` (:func:`default_devices`); a CPU table's
shards stay on the CPU.  Named devices take the shards round-robin the same
way.  Where the list holds one device, every shard stays on the table's
device.  A shard on the table's own device is a set of contiguous views of
the table's tensors and takes no more device memory; a shard on another
device is a copy.  The whole table stays where it was registered.  Shard
rows keep their GLOBAL origin ``block_id`` labels, so merged per-block
statistics index the same block space as the monolithic table.

Sampling.  ``shard_block_ids`` restricts the table's ONE content-derived
Bernoulli realization (``sampling.draw_block_ids``) to each shard's block
range.  The union of the sub-draws *is* the monolithic draw, so the sampled
block set is the same for every shard count (independent per-shard seeds
would give another realization per shard count and break equal-seed replay).
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch.engine.sampling import draw_block_ids, restrict_block_ids
from repro_torch.engine.table import BlockTable


def default_devices(table: BlockTable) -> List[torch.device]:
    """The devices a table's shards go to when none are named: every
    visible card, ``cuda:0`` ... ``cuda:{k-1}`` in index order, for a table
    on a card (the reference's ``jax.devices()``); the table's own device
    otherwise."""
    if table.device.type == "cuda":
        return [torch.device("cuda", i) for i in range(torch.cuda.device_count())]
    return [table.device]


@dataclasses.dataclass(frozen=True)
class Shard:
    """One block-range partition: blocks ``[start_block, end_block)`` of the
    base table, materialized as a standalone :class:`BlockTable` whose
    ``block_id`` column carries the *global* origin block indices."""

    index: int
    start_block: int
    end_block: int
    table: BlockTable

    @property
    def num_blocks(self) -> int:
        return self.end_block - self.start_block

    def local_ids(self, global_ids: np.ndarray) -> np.ndarray:
        """Global sampled block ids restricted to this shard, re-based to
        the shard's local block space."""
        return restrict_block_ids(global_ids, self.start_block, self.end_block)


@dataclasses.dataclass
class ShardedTable:
    """N disjoint, contiguous block-range partitions of one block table."""

    name: str
    shards: List[Shard]
    num_blocks: int          # global block count (== base table's)
    block_rows: int
    row_bytes: int

    @property
    def num_shards(self) -> int:
        return len(self.shards)

    @staticmethod
    def from_table(table: BlockTable, num_shards: int,
                   devices: Optional[Sequence] = None) -> "ShardedTable":
        """Partition ``table`` into ``num_shards`` contiguous block ranges.

        ``devices`` (default: :func:`default_devices`, every visible card
        for a table on one) receive the shard tensors round-robin, shard i
        on ``devices[i % k]``, when it holds more than one; otherwise every
        shard stays on the table's device and "distribution" is independent
        dispatches over disjoint tensors.  The semantics (and the
        bit-identity guarantees) do not depend on placement.
        """
        if num_shards < 1:
            raise ValueError(f"num_shards must be >= 1, got {num_shards}")
        n_blocks = table.num_blocks
        if num_shards > n_blocks:
            raise ValueError(
                f"cannot split {n_blocks} blocks into {num_shards} shards "
                "(blocks are the atomic placement unit)")
        devices = list(devices) if devices is not None else default_devices(table)
        shards: List[Shard] = []
        for i, (lo, hi) in enumerate(_shard_bounds(n_blocks, num_shards)):
            dev = devices[i % len(devices)] if len(devices) > 1 else None
            shards.append(Shard(index=i, start_block=lo, end_block=hi,
                                table=table.slice_blocks(lo, hi, dev)))
        return ShardedTable(name=table.name, shards=shards,
                            num_blocks=n_blocks, block_rows=table.block_rows,
                            row_bytes=table.row_bytes())

    def partition_ids(self, global_ids: np.ndarray) -> List[Tuple[Shard, np.ndarray]]:
        """Split a global sampled-id set into non-empty per-shard sub-draws
        (ascending shard order; ascending local ids within each shard —
        concatenating the per-shard results recovers the global ascending
        order, which the merge relies on)."""
        out: List[Tuple[Shard, np.ndarray]] = []
        for shard in self.shards:
            local = shard.local_ids(global_ids)
            if len(local):
                out.append((shard, local))
        return out


def _shard_bounds(n_blocks: int, num_shards: int) -> List[Tuple[int, int]]:
    """Contiguous near-even block ranges (``np.array_split`` semantics)."""
    base, extra = divmod(n_blocks, num_shards)
    bounds, lo = [], 0
    for i in range(num_shards):
        hi = lo + base + (1 if i < extra else 0)
        bounds.append((lo, hi))
        lo = hi
    return bounds


def shard_block_ids(num_blocks: int, rate: float, seed: int,
                    sharded: ShardedTable) -> Tuple[np.ndarray, List[Tuple[Shard, np.ndarray]]]:
    """The distributed TABLESAMPLE decision: ONE global Bernoulli
    realization (the monolithic samplers' stream), restricted per shard.

    Returns ``(global_ids, [(shard, local_ids), ...])`` with empty shards
    omitted; the union of the per-shard sub-draws equals the monolithic
    draw exactly, for any shard count.
    """
    global_ids = draw_block_ids(num_blocks, rate, seed)
    return global_ids, sharded.partition_ids(global_ids)
