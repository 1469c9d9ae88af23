"""Where shards go when no devices are named: as the reference places them.

The reference's ``ShardedTable.from_table`` spreads shards round-robin over
``jax.devices()`` (``src/repro/dist/shard.py``); the port's over every
visible CUDA card for a table on a card (``dist.shard.default_devices``),
and keeps a CPU table's on the CPU.  Checked here without a card: the pure
function with ``torch.cuda.device_count`` patched, the default's use by
``Session.register_table(shards=)`` and ``DistExecutor.register_sharded``,
and the shard bounds and the ``i % k`` assignment against the reference's
given k device tokens.
"""

import types

import pytest
import torch

import repro.dist.shard as ref_shard
from repro.engine.datagen import tpch_catalog as ref_tpch_catalog
from repro_torch.api import Session, SessionConfig
from repro_torch.dist import DistExecutor, ShardedTable
from repro_torch.dist import shard as port_shard
from repro_torch.engine.datagen import tpch_catalog
from repro_torch.engine.table import BlockTable

ROWS, BLOCK_ROWS = 24_000, 64


@pytest.fixture(scope="module")
def catalog():
    return tpch_catalog(ROWS, BLOCK_ROWS, seed=3, device="cpu")


def _on(device):
    """A stand-in table: ``default_devices`` reads only its device."""
    return types.SimpleNamespace(device=torch.device(device))


@pytest.mark.parametrize("cards", [1, 2, 4])
def test_a_card_table_shards_over_every_visible_card(monkeypatch, cards):
    monkeypatch.setattr(torch.cuda, "device_count", lambda: cards)
    want = [torch.device("cuda", i) for i in range(cards)]
    assert port_shard.default_devices(_on("cuda:0")) == want
    # whichever card the table is on: every card, in index order
    assert port_shard.default_devices(_on(f"cuda:{cards - 1}")) == want


@pytest.mark.parametrize("cards", [0, 4])
def test_a_cpu_table_stays_on_its_device(monkeypatch, catalog, cards):
    monkeypatch.setattr(torch.cuda, "device_count", lambda: cards)
    li = catalog["lineitem"]
    assert port_shard.default_devices(li) == [torch.device("cpu")]
    st = ShardedTable.from_table(li, 4)
    assert [s.table.device for s in st.shards] == [torch.device("cpu")] * 4


def test_shards_on_the_tables_device_are_views(catalog):
    li = catalog["lineitem"]
    st = ShardedTable.from_table(li, 3)
    for s in st.shards:
        row0 = s.start_block * BLOCK_ROWS
        for c, col in s.table.columns.items():
            base = li.columns[c]
            assert col.data_ptr() == base.data_ptr() + row0 * base.element_size(), c
        assert s.table.valid.data_ptr() == li.valid.data_ptr() + row0


def _recorded_default(monkeypatch):
    """``default_devices`` wrapped to record the tables it is asked about."""
    asked = []
    real = port_shard.default_devices

    def default(table):
        asked.append(table)
        return real(table)
    monkeypatch.setattr(port_shard, "default_devices", default)
    return asked


@pytest.mark.parametrize("shards", [1, 4])
def test_register_sharded_takes_the_default(monkeypatch, catalog, shards):
    asked = _recorded_default(monkeypatch)
    ex = DistExecutor(dict(catalog), device="cpu")
    st = ex.register_sharded("lineitem", catalog["lineitem"], shards)
    assert asked == [catalog["lineitem"]]
    assert st.num_shards == shards
    # named devices keep their meaning: the default is not asked
    ex.register_sharded("lineitem", catalog["lineitem"], shards, devices=["cpu"])
    assert asked == [catalog["lineitem"]]


@pytest.mark.parametrize("shards", [2, 7])
def test_session_register_table_takes_the_default(monkeypatch, catalog, shards):
    asked = _recorded_default(monkeypatch)
    s = Session(seed=42, device="cpu", config=SessionConfig(async_workers=0))
    try:
        s.register_table("orders", catalog["orders"])
        s.register_table("lineitem", catalog["lineitem"], shards=shards)
        assert asked == [catalog["lineitem"]]
        assert s.executor.sharded_tables() == {"lineitem": shards}
        # re-registration asks the default again: the session names no devices
        s.register_table("lineitem", catalog["lineitem"], shards=shards)
        assert asked == [catalog["lineitem"]] * 2
    finally:
        s.close()


def test_replicated_tables_are_copied_once_a_device(catalog):
    """Two shards on one device share one replica of every other table."""
    ex = DistExecutor(dict(catalog), device="cpu")
    ex.register_sharded("lineitem", catalog["lineitem"], 4, devices=["cpu", "cpu"])
    execs = ex._shard_executors["lineitem"]
    assert all(e.catalog["orders"] is execs[0].catalog["orders"] for e in execs)


class _Token:
    """A device token: only its identity matters to the assignment."""

    def __init__(self, i):
        self.i = i


@pytest.mark.parametrize("shards,k", [(4, 4), (8, 4), (7, 4), (5, 2), (3, 1)])
def test_bounds_and_round_robin_equal_the_references(monkeypatch, catalog, shards, k):
    tokens = [_Token(i) for i in range(k)]
    ref_placed, port_placed = [], []

    def ref_slice(table, lo, hi, device):
        ref_placed.append((lo, hi, None if device is None else device.i))
        return table
    monkeypatch.setattr(ref_shard, "_slice_blocks", ref_slice)

    def port_slice(self, lo, hi, device=None):
        port_placed.append((lo, hi, None if device is None else device.i))
        return self
    monkeypatch.setattr(BlockTable, "slice_blocks", port_slice)

    ref_li = ref_tpch_catalog(ROWS, BLOCK_ROWS, seed=3)["lineitem"]
    ref_st = ref_shard.ShardedTable.from_table(ref_li, shards, devices=tokens)
    st = ShardedTable.from_table(catalog["lineitem"], shards, devices=tokens)
    assert port_placed == ref_placed
    assert [(s.start_block, s.end_block) for s in st.shards] == \
        [(s.start_block, s.end_block) for s in ref_st.shards]
    if k > 1:
        assert [d for _, _, d in port_placed] == [i % k for i in range(shards)]


def test_the_default_assignment_over_four_cards(monkeypatch, catalog):
    """With four cards visible, shard i goes to ``cuda:{i % 4}``."""
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 4)
    placed = []
    card_table = types.SimpleNamespace(
        device=torch.device("cuda", 0), num_blocks=catalog["lineitem"].num_blocks,
        block_rows=BLOCK_ROWS, name="lineitem", row_bytes=lambda: 37,
        slice_blocks=lambda lo, hi, dev=None: placed.append(dev))
    ShardedTable.from_table(card_table, 7)
    assert placed == [torch.device("cuda", i % 4) for i in range(7)]
