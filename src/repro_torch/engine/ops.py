"""Relational operators on BlockTables, in plain tensor ops: the eager
executor's building blocks (``Executor(use_compiled=False)``) and the two
sides of the sampling-equivalence rules (:mod:`repro_torch.core.equivalence`).

Every group reduction goes through :func:`repro_torch.kernels.segment_sum`
(its plain version on the CPU, its kernels on the card), never through
``index_add_`` on the card, whose float atomics add in an order that changes
from run to run: eager answers are the same bits run to run.
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional, Sequence

import numpy as np
import torch

from repro_torch.engine import syncs
from repro_torch.engine.expr import Expr, eval_expr
from repro_torch.engine.physical import _clamp_groups, _group_ids, channel_matrix
from repro_torch.engine.table import BlockTable
from repro_torch.kernels.segment_sum import segment_sum

_BIG = 2 ** 31 - 1  # the join key of an invalid right row (keys are int32)


def filter_table(table: BlockTable, pred: Expr) -> BlockTable:
    mask = eval_expr(pred, table.columns)
    return dataclasses.replace(table, valid=table.valid & mask)


def join_unique(left: BlockTable, right: BlockTable, left_key: str,
                right_key: str, rblock_col: Optional[str] = None) -> BlockTable:
    """Equi-join where ``right_key`` is unique among valid right rows.

    Preserves the left table's physical layout and block lineage (Prop. 4.5).
    Right columns are appended; optionally the right row's *origin block id*
    is exported as ``rblock_col`` — the pair lineage Lemma 4.8 needs.
    """
    lkey = left.columns[left_key].to(torch.int32)
    rkey = torch.where(right.valid, right.columns[right_key].to(torch.int32), _BIG)
    order = torch.argsort(rkey, stable=True)
    sorted_keys = rkey[order]
    pos = torch.searchsorted(sorted_keys, lkey).clamp(0, sorted_keys.shape[0] - 1)
    found = sorted_keys[pos] == lkey
    match = order[pos]
    new_cols = dict(left.columns)
    for cname, col in right.columns.items():
        if cname == right_key:
            continue
        if cname in new_cols:
            raise ValueError(f"column name collision in join: {cname}")
        new_cols[cname] = col[match]
    if rblock_col is not None:
        new_cols[rblock_col] = right.block_id[match].to(torch.int32)
    return dataclasses.replace(left, columns=new_cols, valid=left.valid & found)


def union_all(tables: List[BlockTable]) -> BlockTable:
    """Bag union; block ids are offset so origins stay distinct (Prop. 4.6)."""
    if not tables:
        raise ValueError("empty union")
    br = tables[0].block_rows
    names = set(tables[0].columns)
    offset, rows = 0, 0
    cols = {c: [] for c in names}
    valids, bids = [], []
    for t in tables:
        if set(t.columns) != names or t.block_rows != br:
            raise ValueError("union inputs must share schema and block size")
        for c in names:
            cols[c].append(t.columns[c])
        valids.append(t.valid)
        bids.append(t.block_id + offset)
        offset += t.num_origin_blocks
        rows += t.num_rows
    return BlockTable(
        name="union",
        columns={c: torch.cat(v) for c, v in cols.items()},
        block_rows=br,
        num_rows=rows,
        valid=torch.cat(valids),
        block_id=torch.cat(bids),
        num_origin_blocks=offset,
    )


# ---------------------------------------------------------------------------
# Aggregation
# ---------------------------------------------------------------------------

def group_ids(table: BlockTable, group_by: Optional[str],
              max_groups: int) -> torch.Tensor:
    """Each row's group, int32 in ``[0, max_groups)``, valid or not (the
    reference's; the executors' own key puts invalid rows in group 0)."""
    if group_by is None:
        return torch.zeros(table.padded_rows, dtype=torch.int32, device=table.device)
    return _clamp_groups(table.columns[group_by], max_groups)


def grouped_counts(table: BlockTable, group_by: Optional[str],
                   max_groups: int) -> torch.Tensor:
    """(max_groups,) f32 count of valid rows per group."""
    return grouped_sums(table, [None], group_by, max_groups)[0]


def grouped_sums(table: BlockTable, exprs: Sequence[Optional[Expr]],
                 group_by: Optional[str], max_groups: int) -> torch.Tensor:
    """(num_aggs, max_groups) sums of each expr per group; a ``None`` expr
    is COUNT, the valid rows.  One segmented sum over every channel."""
    vals = channel_matrix(table.columns, table.valid, exprs)
    gid = _group_ids(table.columns, table.valid, group_by, max_groups)
    return segment_sum(vals, gid, max_groups)


def block_group_sums(table: BlockTable, exprs: Sequence[Optional[Expr]],
                     group_by: Optional[str], max_groups: int,
                     block_ids: np.ndarray) -> np.ndarray:
    """Per-(origin-block, group) sums: (len(block_ids), max_groups, num_aggs).

    The pilot query's "GROUP BY physical block" (§3.3 step 2) — the
    statistics BSAP consumes.  ``block_ids`` lists the sampled origin blocks;
    blocks without surviving rows contribute zeros (they are real population
    units with zero contribution).  One segmented sum over every channel;
    the device→host transfer happens once, here.
    """
    n_origin = int(table.num_origin_blocks)
    vals = channel_matrix(table.columns, table.valid, exprs)
    seg = (table.block_id.to(torch.int64) * max_groups
           + _group_ids(table.columns, table.valid, group_by, max_groups))
    dense = segment_sum(vals, seg, n_origin * max_groups)
    stacked = dense.reshape(len(exprs), n_origin, max_groups).permute(1, 2, 0)
    idx = torch.as_tensor(np.asarray(block_ids, np.int64), device=table.device)
    out = stacked[idx].double()
    with syncs.host_read(out):
        return out.cpu().numpy()


def block_pair_sums(table: BlockTable, exprs: Sequence[Optional[Expr]],
                    lblock_ids: np.ndarray, rblock_col: str,
                    n_right_blocks: int) -> np.ndarray:
    """Per-(left origin block, right origin block) sums for Lemma 4.8:
    (len(lblock_ids), n_right_blocks, num_aggs).

    Left origin blocks are compacted to their position among ``lblock_ids``
    first, so the dense buffer is n_p x N2, not N1 x N2; rows of other
    blocks land in a scratch slot that is sliced away.
    """
    dev = table.device
    lblock = torch.as_tensor(np.asarray(lblock_ids, np.int64), device=dev)
    n_p = lblock.shape[0]
    lut = torch.full((int(table.num_origin_blocks),), n_p, dtype=torch.int64, device=dev)
    lut[lblock] = torch.arange(n_p, dtype=torch.int64, device=dev)
    rb = torch.where(table.valid, table.columns[rblock_col].to(torch.int64), 0)
    seg = lut[table.block_id.to(torch.int64)] * n_right_blocks + rb
    vals = channel_matrix(table.columns, table.valid, exprs)
    dense = segment_sum(vals, seg, (n_p + 1) * n_right_blocks)
    out = dense.reshape(len(exprs), n_p + 1, n_right_blocks)[:, :n_p]
    out = out.permute(1, 2, 0).double()
    with syncs.host_read(out):
        return out.cpu().numpy()
