"""The plain reference against float64 numpy at a small size, and the
table generator's distributions."""

import json
from pathlib import Path

import numpy as np
import pytest
import torch

from pilotbench import check, reference, tables
from pilotbench.reference import tpch_days
from pilotbench.traffic import make_query

CONFIG = json.loads((Path(__file__).resolve().parents[1] / "configs" / "tpch_sf10.json").read_text())
ROWS, BR = 64_000, 32


@pytest.fixture(scope="module")
def data():
    cfg = dict(CONFIG, lineitem_rows=ROWS)
    return tables.make_tables(cfg, 2 ** 31 + 5, "cpu")


def numpy_cols(data):
    return {k: v.numpy() for k, v in data["lineitem"].items()}


def test_generator_is_seeded_and_full_width(data):
    cfg = dict(CONFIG, lineitem_rows=ROWS)
    again = tables.make_tables(cfg, 2 ** 31 + 5, "cpu")["lineitem"]
    other = tables.make_tables(cfg, 6, "cpu")["lineitem"]
    assert len(data["lineitem"]) == 18      # lineitem's 16 columns, l_rf_ls and p_promo
    assert not any(k.startswith("_") for k in data["lineitem"])
    for k, v in data["lineitem"].items():
        assert torch.equal(v, again[k])
        assert not torch.equal(v, other[k]) or k == "l_linenumber"
        assert v.shape == (ROWS,)


def test_generator_follows_dbgen(data):
    c = numpy_cols(data)
    current = tpch_days(1995, 6) + 16                  # 1995-06-17
    # orders of 1-7 lines with sparse keys; line numbers count within each
    key, line = c["l_orderkey"].astype(np.int64), c["l_linenumber"]
    starts = np.flatnonzero(np.r_[True, key[1:] != key[:-1]])
    runs = np.diff(np.r_[starts, len(key)])
    assert runs[:-1].min() == 1 and runs.max() == 7
    assert abs(runs[:-1].mean() - 4) < 0.05
    assert (line[starts] == 1).all() and ((key & 31) < 8).all()
    # the dates follow the order date, and the flags follow the dates
    ship, commit, receipt = c["l_shipdate"], c["l_commitdate"], c["l_receiptdate"]
    assert 1 <= ship.min() and ship.max() <= 2405 + 121
    assert ((receipt - ship >= 1) & (receipt - ship <= 30)).all()
    assert ((commit - ship >= 30 - 121) & (commit - ship <= 90 - 1)).all()
    rf, ls = c["l_returnflag"], c["l_linestatus"]
    assert ((rf == 1) == (receipt > current)).all()
    assert ((ls == 1) == (ship > current)).all()
    assert abs((rf == 0).sum() / (rf != 1).sum() - 0.5) < 0.02
    # l_rf_ls is the pair in Q1's order AF, NF, NO, RF
    pairs = {0: (0, 0), 1: (1, 0), 2: (1, 1), 3: (2, 0)}
    for k, (a, b) in pairs.items():
        m = c["l_rf_ls"] == k
        assert m.any() and (rf[m] == a).all() and (ls[m] == b).all()
    assert 0.003 < (c["l_rf_ls"] == 1).mean() < 0.01
    # prices from the part key, measures on dbgen's grids
    pk = c["l_partkey"].astype(np.int64)
    cents = 90000 + (pk // 10) % 20001 + 100 * (pk % 1000)
    np.testing.assert_allclose(c["l_extendedprice"], c["l_quantity"] * cents / 100, rtol=1e-7)
    assert set(np.unique(c["l_quantity"])) == set(np.arange(1, 51, dtype=np.float32))
    assert set(np.round(np.unique(c["l_discount"]) * 100).astype(int)) == set(range(11))
    assert set(np.round(np.unique(c["l_tax"]) * 100).astype(int)) == set(range(9))
    s = c["l_suppkey"].astype(np.int64)
    assert 1 <= s.min() and s.max() <= 100_000
    # the part's PROMO flag, one type in six, the same for every line of a part
    assert abs(c["p_promo"].mean() - 1 / 6) < 0.01
    first = {}
    for k, f in zip(pk[:5000], c["p_promo"][:5000]):
        assert first.setdefault(k, f) == f
    assert set(np.unique(c["l_shipinstruct"])) == set(range(4))
    assert set(np.unique(c["l_shipmode"])) == set(range(7))


def numpy_answer(c, family, p):
    """The same queries written straight in numpy, float64."""
    ph = reference.family(family).placeholders(p)
    sd, qty = c["l_shipdate"], c["l_quantity"].astype(np.float64)
    price, disc = c["l_extendedprice"].astype(np.float64), c["l_discount"]
    d64, tax = disc.astype(np.float64), c["l_tax"].astype(np.float64)
    if family == "q6":
        m = ((sd >= ph["date_lo"]) & (sd < ph["date_hi"])
             & (disc >= np.float32(ph["disc_lo"])) & (disc <= np.float32(ph["disc_hi"]))
             & (c["l_quantity"] < ph["quantity"]))
        return np.array([[np.sum(price[m] * d64[m])]])
    if family == "q1":
        out = np.zeros((8, 4))
        for g in range(4):
            m = (sd <= ph["date_hi"]) & (c["l_rf_ls"] == g)
            dp = price[m] * (1 - d64[m])
            out[:, g] = [qty[m].sum(), price[m].sum(), dp.sum(), (dp * (1 + tax[m])).sum(),
                         qty[m].mean(), price[m].mean(), d64[m].mean(), m.sum()]
        return out
    if family == "q14":
        m = (sd >= ph["date_lo"]) & (sd < ph["date_hi"])
        rev = price[m] * (1 - d64[m])
        return np.array([[np.sum(rev * c["p_promo"][m]) / np.sum(rev)]])
    return np.array([[price.sum()], [float(len(price))]])


CASES = [("q6", {"year": 1994, "discount": 0.06, "quantity": 24}),
         ("q6", {"year": 1997, "discount": 0.02, "quantity": 25}),
         ("q1", {"delta": 60}), ("q1", {"delta": 120}),
         ("q14", {"year": 1995, "month": 12}), ("sum_count", {})]


@pytest.mark.parametrize("family,params", CASES)
def test_exact_matches_numpy(data, family, params):
    ref = check.Reference(data, BR)
    got, present = ref.exact(make_query(family, params, None))
    want = numpy_answer(numpy_cols(data), family, params)
    assert present.all()
    np.testing.assert_allclose(got, want, rtol=1e-12)


@pytest.mark.parametrize("family,params", CASES)
def test_sample_estimate_matches_numpy(data, family, params):
    ids = np.sort(np.random.default_rng(3).choice(ROWS // BR, 400, replace=False))
    ref = check.Reference(data, BR)
    q = make_query(family, params, (5, 95))
    got, _ = ref.sample(q, check.Sample((check.Final("lineitem", 0.2, ids, ROWS // BR,
                                                     len(ids)),)))
    rows = (ids[:, None] * BR + np.arange(BR)).ravel()
    sub = {k: v[rows] for k, v in numpy_cols(data).items()}
    want = numpy_answer(sub, family, params)
    fam = reference.family(family)
    for k, (_, kind, _) in enumerate(fam.COMPOSITES):
        if kind in ("sum", "count"):
            want[k] *= (ROWS // BR) / len(ids)
    np.testing.assert_allclose(got, want, rtol=1e-12)


def test_bfloat16_control_is_far_from_float64(data):
    q = make_query("q1", {"delta": 90}, None)
    hi, _ = check.Reference(data, BR).exact(q)
    lo, _ = check.Reference(data, BR, dtype=torch.bfloat16).exact(q)
    assert reference.relative_gap(lo, hi) > 1e-3


def test_relative_gap():
    assert reference.relative_gap(np.array([1.0, 2.0]), np.array([1.0, 2.0])) == 0.0
    assert reference.relative_gap(np.array([1.1]), np.array([1.0])) == pytest.approx(0.1)
    assert reference.relative_gap(np.array([np.nan]), np.array([1.0])) == float("inf")
    assert reference.relative_gap(np.array([np.nan]), np.array([np.nan])) == 0.0


def test_a_table_sorted_by_a_column_keeps_its_rows():
    cfg = dict(CONFIG, lineitem_rows=ROWS, lineitem_sort_by="l_shipdate")
    s = tables.make_tables(cfg, 2 ** 31 + 5, "cpu")["lineitem"]
    u = tables.make_tables(dict(CONFIG, lineitem_rows=ROWS), 2 ** 31 + 5, "cpu")["lineitem"]
    assert (s["l_shipdate"][1:] >= s["l_shipdate"][:-1]).all()
    key = lambda c: sorted(zip(c["l_orderkey"].tolist(), c["l_linenumber"].tolist(),
                               c["l_extendedprice"].tolist()))
    assert key(s) == key(u)


def test_register_options_are_data():
    assert set(tables.register_options(CONFIG, "lineitem")["dictionaries"]) == {
        "l_returnflag", "l_linestatus", "l_shipinstruct", "l_shipmode", "l_rf_ls"}
    assert tables.register_options(CONFIG, "orders") == {}
