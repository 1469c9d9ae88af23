"""The byte counts of the roofline shares against hand counts, and the
share arithmetic the readers use."""

import json
from pathlib import Path
from types import SimpleNamespace

import pytest

from pilotbench import roofline
from pilotbench.metrics import roofline_pct

CONFIG = json.loads((Path(__file__).resolve().parents[1] / "configs" / "tpch_sf10.json").read_text())


def test_row_bytes():
    # Q6 reads l_shipdate, l_discount, l_quantity, l_extendedprice: 4 x 4 bytes
    assert roofline.row_bytes(CONFIG, "lineitem", ("l_shipdate", "l_discount",
                                                   "l_quantity", "l_extendedprice")) == 16


def test_row_bytes_of_codes():
    # one-byte dictionary codes beside int32 keys and a float32 measure
    assert roofline.row_bytes(CONFIG, "lineitem", ("l_returnflag", "l_linestatus",
                                                   "l_rf_ls", "p_promo")) == 4
    assert roofline.row_bytes(CONFIG, "lineitem", ("l_orderkey", "l_tax", "l_comment",
                                                   "l_shipmode")) == 13


def test_segment_sum_bytes():
    # Q1 exact: 5 value channels and a key in per row, 6 channels x 4 groups out
    assert roofline.segment_sum_bytes(100, 5, 4, 6) == 100 * 24 + 96


def test_share():
    ctx = SimpleNamespace(device_kind="NVIDIA H100 80GB HBM3")
    # 3.35 GB in 2 ms is half of the peak
    assert roofline_pct(ctx, 3.35e9, 2e-3) == pytest.approx(50.0)
    assert roofline_pct(ctx, 1.0, 0.0) is None
    assert roofline_pct(SimpleNamespace(device_kind="cpu"), 1.0, 1.0) is None
