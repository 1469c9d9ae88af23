"""Synthetic benchmark data.

Mirrors the paper's evaluation corpora.  The numpy generators are the
reference's, so a seed gives the same bytes in both packages; only the
placement differs (``device``, the card by default):

* ``make_lineitem`` / ``make_orders`` — TPC-H-like star schema (Q1/Q6/Q14-ish
  queries in benchmarks/), with a ``clustered`` switch that sorts the fact
  table by ship date.  Clustered layouts give homogeneous blocks — the regime
  where naive row-level CLT under block sampling fails hardest (Fig. 16/17)
  and where Lemma 4.1's efficiency ratio is worst.
* ``make_skewed`` — DSB-like skew: exponential aggregation column, Zipf-ish
  group sizes, correlated join keys (§5.3 "PilotDB Accelerates Queries on
  Skewed Data").
"""

from __future__ import annotations

from typing import Dict, Tuple

import numpy as np

from repro_torch.engine.table import BlockTable


def make_lineitem(num_rows: int = 200_000, block_rows: int = 256, *,
                  num_orders: int = 50_000, clustered: bool = False,
                  seed: int = 0, device="cuda") -> BlockTable:
    rng = np.random.default_rng(seed)
    shipdate = rng.integers(0, 2526, size=num_rows)  # days since 1992-01-01
    if clustered:
        shipdate = np.sort(shipdate)
    quantity = rng.integers(1, 51, size=num_rows).astype(np.float32)
    extendedprice = (quantity * rng.uniform(900.0, 1100.0, num_rows)).astype(np.float32)
    discount = rng.integers(0, 11, size=num_rows).astype(np.float32) / 100.0
    tax = rng.integers(0, 9, size=num_rows).astype(np.float32) / 100.0
    orderkey = rng.integers(0, num_orders, size=num_rows).astype(np.int32)
    returnflag = rng.integers(0, 3, size=num_rows).astype(np.int32)
    linestatus = rng.integers(0, 2, size=num_rows).astype(np.int32)
    return BlockTable.from_numpy(
        "lineitem",
        {
            "l_orderkey": orderkey,
            "l_quantity": quantity,
            "l_extendedprice": extendedprice,
            "l_discount": discount,
            "l_tax": tax,
            "l_shipdate": shipdate.astype(np.int32),
            "l_returnflag": returnflag,
            "l_linestatus": linestatus,
        },
        block_rows,
        device,
    )


def make_orders(num_orders: int = 50_000, block_rows: int = 256, *,
                seed: int = 1, device="cuda") -> BlockTable:
    rng = np.random.default_rng(seed)
    orderkey = np.arange(num_orders, dtype=np.int32)
    rng.shuffle(orderkey)  # physical order decorrelated from key
    totalprice = rng.gamma(4.0, 30_000.0, num_orders).astype(np.float32)
    orderdate = rng.integers(0, 2406, size=num_orders).astype(np.int32)
    custkey = rng.integers(0, max(num_orders // 10, 1), size=num_orders).astype(np.int32)
    orderpriority = rng.integers(0, 5, size=num_orders).astype(np.int32)
    return BlockTable.from_numpy(
        "orders",
        {
            "o_orderkey": orderkey,
            "o_totalprice": totalprice,
            "o_orderdate": orderdate,
            "o_custkey": custkey,
            "o_orderpriority": orderpriority,
        },
        block_rows,
        device,
    )


def make_skewed(num_rows: int = 200_000, block_rows: int = 256, *,
                num_groups: int = 8, seed: int = 7,
                clustered_groups: bool = False, device="cuda") -> BlockTable:
    """DSB-like skewed fact table: exponential measure, Zipf group sizes."""
    rng = np.random.default_rng(seed)
    measure = rng.exponential(100.0, num_rows).astype(np.float32)
    # Zipf-ish group assignment
    weights = 1.0 / np.arange(1, num_groups + 1) ** 1.2
    weights /= weights.sum()
    group = rng.choice(num_groups, size=num_rows, p=weights).astype(np.int32)
    if clustered_groups:
        order = np.argsort(group, kind="stable")
        measure, group = measure[order], group[order]
    filter_col = rng.uniform(0.0, 1.0, num_rows).astype(np.float32)
    key = rng.integers(0, max(num_rows // 8, 1), size=num_rows).astype(np.int32)
    return BlockTable.from_numpy(
        "skewed",
        {"s_measure": measure, "s_group": group, "s_filter": filter_col, "s_key": key},
        block_rows,
        device,
    )


def tpch_catalog(scale_rows: int = 200_000, block_rows: int = 256, *,
                 clustered: bool = False, seed: int = 0,
                 device="cuda") -> Dict[str, BlockTable]:
    num_orders = max(scale_rows // 4, 16)
    return {
        "lineitem": make_lineitem(scale_rows, block_rows, num_orders=num_orders,
                                  clustered=clustered, seed=seed, device=device),
        "orders": make_orders(num_orders, block_rows, seed=seed + 1,
                              device=device),
    }
