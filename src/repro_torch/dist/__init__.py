"""Partitioned tables and shard-parallel execution: block-range
ShardedTables (on the table's device, or round-robin over the CUDA devices
the caller names), restriction-based per-shard Bernoulli sub-draws of the one
content-derived realization, and per-shard dispatches merged through
per-block BSAP statistics in f64 — bit-identical for every shard count by
construction."""

from repro_torch.dist.executor import DistExecutor
from repro_torch.dist.merge import (ShardPart, merge_block_stats,
                                    merge_pilot_stats, reduce_group_totals)
from repro_torch.dist.shard import Shard, ShardedTable, shard_block_ids

__all__ = [
    "DistExecutor",
    "ShardedTable",
    "Shard",
    "shard_block_ids",
    "ShardPart",
    "merge_block_stats",
    "merge_pilot_stats",
    "reduce_group_totals",
]
