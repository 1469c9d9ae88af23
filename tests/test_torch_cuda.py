"""The hand-written CUDA kernels on the card: against their plain PyTorch
versions, bitwise stable between launches, and counted.

Marked ``cuda``; each test skips where no CUDA card is present.  Run on a
machine with one: ``PYTHONPATH=src python -m pytest -q -m cuda tests/``.
"""

import numpy as np
import pytest
import torch

from repro_torch.api import Session
from repro_torch.engine.datagen import tpch_catalog
from repro_torch.kernels.block_agg import block_agg, block_agg_ref
from repro_torch.kernels.filtered_agg import filtered_agg, filtered_agg_ref

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card; the CPU route is covered by "
                    "test_torch_kernels.py")
    return torch.device("cuda")


def _columns(block_rows, n_blocks, dev, seed):
    rng = np.random.default_rng(seed)
    n = n_blocks * block_rows
    price = rng.uniform(900.0, 1100.0, n).astype(np.float32)
    discount = rng.integers(0, 11, n).astype(np.float32) / 100.0
    shipdate = rng.integers(0, 2526, n).astype(np.int32)
    valid = rng.random(n) < 0.9
    valid[:block_rows] = False                      # block 0 is empty
    ids = np.concatenate([rng.integers(0, n_blocks, 200), [0, 0, 7, 7],
                          np.zeros(20)]).astype(np.int32)
    t = lambda a: torch.from_numpy(a).to(dev)
    return t(price), t(discount), t(shipdate), t(valid), t(ids)


@pytest.mark.parametrize("block_rows", [32, 100, 256])
def test_kernels_match_plain_versions_on_the_card(cuda, block_rows):
    price, discount, shipdate, valid, ids = _columns(block_rows, 500, cuda, 1)
    bounds = torch.tensor([100.0, 1500.0, 0.02, 0.08, 3e38],
                          dtype=torch.float32, device=cuda)
    launches = filtered_agg.launches, block_agg.launches
    a = filtered_agg(price, discount, shipdate, discount, shipdate, valid,
                     block_rows, ids, bounds)
    b = filtered_agg(price, discount, shipdate, discount, shipdate, valid,
                     block_rows, ids, bounds)
    ref = filtered_agg_ref(price, discount, shipdate, discount, shipdate,
                           valid, block_rows, ids, bounds)
    assert torch.equal(a.view(torch.int32), b.view(torch.int32))
    assert torch.equal(a[:, 0], ref[:, 0])
    torch.testing.assert_close(a[:, 1:], ref[:, 1:], rtol=1e-5, atol=0)
    for col in (price, shipdate, valid):
        c = block_agg(col, valid, block_rows, ids)
        # bitwise, NaN sentinel included (torch.equal treats NaN != NaN)
        again = block_agg(col, valid, block_rows, ids)
        assert torch.equal(c.view(torch.int32), again.view(torch.int32))
        r = block_agg_ref(col, valid, block_rows, ids)
        assert torch.equal(c[:, 0], r[:, 0])
        torch.testing.assert_close(c[:, 1:3], r[:, 1:3], rtol=1e-5, atol=0)
        torch.testing.assert_close(c[:, 3:], r[:, 3:], rtol=0, atol=0,
                                   equal_nan=True)
    torch.cuda.synchronize()
    assert (filtered_agg.launches, block_agg.launches) == \
        (launches[0] + 2, launches[1] + 6)


def test_cuda_session_matches_cpu_session(cuda):
    q6 = ("SELECT SUM(l_extendedprice * l_discount) AS revenue FROM lineitem "
          "WHERE l_shipdate BETWEEN 100 AND 1500 AND l_discount BETWEEN 0.02 "
          "AND 0.08 ERROR 10% CONFIDENCE 95%")
    hs = []
    for dev in ("cuda", "cpu"):
        s = Session(tpch_catalog(200_000, 32, seed=0, device=dev), seed=42,
                    device=dev)
        hs.append(s.sql(q6))
    g, c = hs
    assert g.status == c.status == "done"
    assert g.fallback == c.fallback
    assert g.report.n_pilot_blocks == c.report.n_pilot_blocks
    assert g.report.plan.rates["lineitem"] == pytest.approx(
        c.report.plan.rates["lineitem"], rel=1e-6)
    np.testing.assert_allclose(g.answer.values, c.answer.values, rtol=1e-5)
