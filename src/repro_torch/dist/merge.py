"""Combining per-shard BSAP state: block statistics, partial aggregates,
group bitmaps.

Everything the dist executor moves between shards is *per-block*: each
shard's dispatch returns the per-(sampled block, group) channel sums of its
own blocks, and this module combines them.  Per-block granularity is what
makes the combination exact:

* a block is never split across shards, so a block's f32 channel sums are
  computed wholly inside one dispatch and do not depend on which other
  blocks shared it, nor on the dispatch's block count: the column kernels
  and ``segment_sum``'s slab route give one warp each block and add its
  rows in a fixed order, whatever the blocks per warp;
* concatenating per-shard rows in ascending shard order recovers the global
  ascending sampled-id order — bit-identical to a monolithic dispatch's
  block-statistics matrix;
* group totals are then DEFINED as the float64 reduction of the per-block
  sums in that global block order.  The reduction's input array is
  identical for every shard count, so the result is shard-count-invariant
  bitwise — re-sharding a table can never change an answer.

(The monolithic non-sharded route reduces in f32 on the device instead;
the two routes agree to f32 rounding, and exactly on counts and group
bitmaps, whose summands are integers.)

Empty samples keep the engine-wide semantics: a sampled scan whose GLOBAL
draw selects zero blocks raises :class:`repro_torch.engine.executor.EmptySampleError`
— no unbiased upscale exists, and TAQA takes its explicit exact-execution
fallback.  A single *shard* drawing zero blocks is not an error: it simply
contributes no rows to the merge.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Tuple

import numpy as np

from repro_torch.engine.executor import EmptySampleError, PilotStats

__all__ = ["ShardPart", "merge_block_stats", "reduce_group_totals",
           "merge_pilot_stats", "EmptySampleError"]


@dataclasses.dataclass
class ShardPart:
    """One shard dispatch's contribution to a merge.

    ``block_sums`` is ``(n_real, max_groups, num_channels)`` float64 — the
    shard's per-(sampled block, group) channel sums, rows in ascending
    global block order.  ``pair_sums`` is the optional Lemma-4.8 per
    block-pair matrix ``(n_real, n_right, num_channels)``.
    """

    shard_index: int
    global_ids: np.ndarray               # (n_real,) ascending global block ids
    block_sums: np.ndarray
    pair_sums: Optional[np.ndarray] = None
    scanned_bytes: int = 0


def merge_block_stats(parts: List[ShardPart]) -> Tuple[np.ndarray, np.ndarray]:
    """Concatenate per-shard block statistics in global block order.

    Returns ``(global_ids, block_sums)`` with rows ascending in global
    block id — the same matrix a monolithic dispatch over the union of the
    sampled blocks produces.  Parts must arrive in ascending shard order
    (``ShardedTable.partition_ids`` emits them that way).
    """
    if not parts:
        raise ValueError("merge_block_stats needs at least one shard part")
    ids = np.concatenate([p.global_ids for p in parts])
    if len(ids) > 1 and not np.all(np.diff(ids) > 0):
        raise ValueError("shard parts must concatenate to ascending "
                         "global block order (disjoint ranges, shard order)")
    return ids, np.concatenate([p.block_sums for p in parts], axis=0)


def reduce_group_totals(block_sums: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
    """Per-group channel totals from merged per-block statistics.

    ``block_sums`` is ``(n_blocks, max_groups, num_channels)`` where the
    LAST channel is the surviving-row count ("__rows").  Returns
    ``(sums (num_aggs, max_groups), counts (max_groups,))`` as float64
    reductions over blocks in the given (global) order — deterministic and
    shard-count-invariant because the input array is.
    """
    totals = block_sums.astype(np.float64, copy=False).sum(axis=0)  # (mg, C)
    channels = totals.T                                             # (C, mg)
    return channels[:-1], channels[-1]


def merge_group_present(block_sums: np.ndarray) -> np.ndarray:
    """Group-presence bitmap: a group exists iff any merged block saw a
    surviving row (row counts are non-negative, so the OR over shards and
    the sign of the summed count agree exactly)."""
    if block_sums.shape[0] == 0:
        return np.zeros(block_sums.shape[1], dtype=bool)
    return block_sums[:, :, -1].sum(axis=0) > 0


def merge_pilot_stats(
    *,
    table: str,
    theta_p: float,
    n_total_blocks: int,
    block_rows: int,
    agg_names: List[str],
    max_groups: int,
    parts: List[ShardPart],
    pair_table: Optional[str] = None,
    n_right_blocks: int = 0,
    replicated_bytes: int = 0,
    wall_time_s: float = 0.0,
) -> PilotStats:
    """Combine per-shard pilot dispatches into one :class:`PilotStats`.

    The merged ``block_sums``/``pair_sums`` are bit-identical to a
    monolithic pilot over the same sampled set (per-block statistics are
    dispatch-invariant); ``scanned_bytes`` charges each shard its own
    sampled slabs plus the replicated (unsharded) tables once.
    """
    num_channels = len(agg_names)
    if not parts:
        return PilotStats(
            table=table, theta_p=theta_p, n_sampled_blocks=0,
            n_total_blocks=n_total_blocks, block_rows=block_rows,
            agg_names=agg_names,
            block_sums=np.zeros((0, max_groups, num_channels)),
            group_present=np.zeros(max_groups, bool),
            pair_sums={}, right_total_blocks={},
            scanned_bytes=replicated_bytes, wall_time_s=wall_time_s)
    ids, block_sums = merge_block_stats(parts)
    pair_sums: Dict[str, np.ndarray] = {}
    right_total: Dict[str, int] = {}
    if pair_table is not None and all(p.pair_sums is not None for p in parts):
        pair_sums[pair_table] = np.concatenate(
            [p.pair_sums for p in parts], axis=0)
        right_total[pair_table] = n_right_blocks
    return PilotStats(
        table=table,
        theta_p=theta_p,
        n_sampled_blocks=int(len(ids)),
        n_total_blocks=n_total_blocks,
        block_rows=block_rows,
        agg_names=agg_names,
        block_sums=block_sums,
        group_present=merge_group_present(block_sums),
        pair_sums=pair_sums,
        right_total_blocks=right_total,
        scanned_bytes=sum(p.scanned_bytes for p in parts) + replicated_bytes,
        wall_time_s=wall_time_s,
    )
