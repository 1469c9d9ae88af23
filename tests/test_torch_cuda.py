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
from repro_torch.kernels.block_agg import (block_agg, block_agg_batched,
                                           block_agg_batched_ref, block_agg_ref)
from repro_torch.kernels.filtered_agg import (filtered_agg, filtered_agg_batched,
                                              filtered_agg_batched_ref,
                                              filtered_agg_ref)

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


def _bits(t):
    return t.contiguous().view(torch.int32)


@pytest.mark.parametrize("block_rows", [32, 100, 256])
def test_batched_kernels_match_plain_and_solo_on_the_card(cuda, block_rows):
    """Each lane of one batched launch: against the batched plain version
    (counts exact, sums rtol 1e-5, min/max exact), bitwise equal to a solo
    launch on that lane's ids and bounds, and bitwise stable launch to
    launch."""
    price, discount, shipdate, valid, ids1 = _columns(block_rows, 500, cuda, 2)
    rng = np.random.default_rng(3)
    n_phys = ids1.shape[0]
    ids = torch.stack([ids1, ids1.flip(0).contiguous(), torch.from_numpy(
        rng.integers(0, 500, n_phys).astype(np.int32)).to(cuda)]).contiguous()
    ids[2, -16:] = 0                                # zero padding
    bounds = torch.tensor([[100.0, 1500.0, 0.02, 0.08, 3e38],
                           [0.0, 2525.0, 0.05, 0.07, 2000.0],
                           [-3e38, 3e38, 0.0, 0.02, 800.0]],
                          dtype=torch.float32, device=cuda)
    before = (filtered_agg_batched.launches, block_agg_batched.launches)
    fa = (price, discount, shipdate, discount, shipdate, valid, block_rows)
    a = filtered_agg_batched(*fa, ids, bounds)
    assert torch.equal(_bits(a), _bits(filtered_agg_batched(*fa, ids, bounds)))
    ref = filtered_agg_batched_ref(*fa, ids, bounds)
    assert torch.equal(a[..., 0], ref[..., 0])
    torch.testing.assert_close(a[..., 1:], ref[..., 1:], rtol=1e-5, atol=0)
    for b in range(3):
        solo = filtered_agg(*fa, ids[b].contiguous(), bounds[b].contiguous())
        assert torch.equal(_bits(a[b]), _bits(solo))
    for col in (price, shipdate, valid):
        c = block_agg_batched(col, valid, block_rows, ids)
        assert torch.equal(_bits(c),
                           _bits(block_agg_batched(col, valid, block_rows, ids)))
        r = block_agg_batched_ref(col, valid, block_rows, ids)
        assert torch.equal(c[..., 0], r[..., 0])
        torch.testing.assert_close(c[..., 1:3], r[..., 1:3], rtol=1e-5, atol=0)
        torch.testing.assert_close(c[..., 3:], r[..., 3:], rtol=0, atol=0,
                                   equal_nan=True)
        for b in range(3):
            solo = block_agg(col, valid, block_rows, ids[b].contiguous())
            assert torch.equal(_bits(c[b]), _bits(solo))
    torch.cuda.synchronize()
    assert (filtered_agg_batched.launches, block_agg_batched.launches) == \
        (before[0] + 2, before[1] + 6)


def test_cuda_drain_matches_cuda_serial_session(cuda):
    """Submit + drain on the card (threads, shared pilots, batched finals)
    answers bitwise like an equal-seed serial session's Session.sql, and
    launches both batched kernels."""
    from repro_torch.api import SessionConfig
    cat = tpch_catalog(200_000, 32, seed=0, device="cuda")
    q6 = ("SELECT SUM(l_extendedprice * l_discount) AS rev FROM lineitem "
          "WHERE l_quantity < {} ERROR 8% CONFIDENCE 95%")
    sc = ("SELECT SUM(l_extendedprice) AS s, COUNT(*) AS n FROM lineitem "
          "ERROR {}% CONFIDENCE 95%")
    herd = [q6.format(c) for c in (18, 21, 24, 27, 30, 33)] + \
        [sc.format(e) for e in (5, 6, 7, 8)]
    before = (filtered_agg_batched.launches, block_agg_batched.launches)
    s = Session(cat, seed=21, config=SessionConfig(async_workers=4))
    hs = [s.submit(q) for q in herd]
    s.drain()
    serial = Session(cat, seed=21, config=SessionConfig(
        async_workers=0, share_pilots=False,
        result_cache_size=0))
    try:
        for h, q in zip(hs, herd):
            r = serial.sql(q)
            assert h.status == r.status == "done"
            np.testing.assert_array_equal(h.answer.values, r.answer.values)
        assert filtered_agg_batched.launches > before[0]
        assert block_agg_batched.launches > before[1]
    finally:
        s.close()
        serial.close()


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


# -- the model kernels: flash_attn and gla_chunk ----------------------------------

def _normal(rng, shape, dev, dtype, scale=1.0):
    a = (rng.standard_normal(shape) * scale).astype(np.float32)
    return torch.from_numpy(a).to(dev).to(dtype)


# (B, Hq, Hkv, Sq, Skv, d, dtype, causal, window): hymba's GQA and window at
# a short sequence and at the eval shape, internlm2's d 128, ragged and
# non-causal (bf16: Sq and Skv off the tiles, for TMA's zero fill), f32 and
# bf16
FLASH_CASES = [
    (2, 10, 2, 300, 300, 64, torch.bfloat16, True, 128),
    (1, 4, 4, 200, 200, 64, torch.float32, True, 0),
    (1, 8, 2, 100, 150, 128, torch.float32, False, 0),
    (2, 4, 2, 130, 130, 128, torch.bfloat16, True, 0),
    (1, 5, 1, 257, 257, 64, torch.float32, False, 64),
    (2, 25, 5, 2048, 2048, 64, torch.bfloat16, True, 1024),
    (1, 6, 2, 201, 333, 128, torch.bfloat16, False, 0),
]


@pytest.mark.parametrize("case", FLASH_CASES)
def test_flash_attention_matches_plain_version_on_the_card(cuda, case):
    """Against the dense f32 plain version: f32 at the reference's own 2e-3;
    bf16 at rtol 1e-2, atol 1e-4, since both compute in f32 and round once to
    bf16, so they differ by at most one bf16 step (2^-7 |o|).  Bitwise
    stable between launches, one launch counted per call."""
    from repro_torch.kernels.flash_attn import flash_attention, flash_attention_ref
    b, hq, hkv, sq, skv, d, dtype, causal, window = case
    rng = np.random.default_rng(sq + d)
    q = _normal(rng, (b, hq, sq, d), cuda, dtype)
    k = _normal(rng, (b, hkv, skv, d), cuda, dtype)
    v = _normal(rng, (b, hkv, skv, d), cuda, dtype)
    before = flash_attention.launches
    got = flash_attention(q, k, v, causal=causal, window=window)
    again = flash_attention(q, k, v, causal=causal, window=window)
    torch.cuda.synchronize()
    assert flash_attention.launches == before + 2
    assert got.dtype == dtype and got.shape == q.shape
    assert torch.equal(got, again)
    want = flash_attention_ref(q, k, v, causal=causal, window=window)
    rtol, atol = (1e-2, 1e-4) if dtype == torch.bfloat16 else (2e-3, 2e-3)
    torch.testing.assert_close(got.float(), want.float(), rtol=rtol, atol=atol)


# (B, H, T, dk, dv, dtype): hymba's (16, 64) and rwkv6's (64, 64), T off the
# chunk, f32 and bf16; hymba's eval shape (32 chunks) and a ragged tail after
# 15 chunks
GLA_CASES = [
    (2, 5, 200, 16, 64, torch.bfloat16),
    (1, 3, 130, 64, 64, torch.float32),
    (2, 2, 256, 16, 64, torch.float32),
    (1, 2, 100, 64, 64, torch.bfloat16),
    (2, 25, 2048, 16, 64, torch.bfloat16),
    (1, 3, 1000, 64, 64, torch.float32),
]


@pytest.mark.parametrize("case", GLA_CASES)
def test_gla_chunked_matches_plain_version_on_the_card(cuda, case):
    """o and the final state against the plain chunked version (3e-3 for
    f32, the reference's; 2e-2 for bf16 outputs), with decays down to and
    past the -8 clamp; bitwise stable between launches."""
    from repro_torch.kernels.gla_chunk import gla_chunked, gla_chunked_ref
    b, h, t, dk, dv, dtype = case
    rng = np.random.default_rng(t + dk)
    q = _normal(rng, (b, h, t, dk), cuda, dtype, 0.5)
    k = _normal(rng, (b, h, t, dk), cuda, dtype, 0.5)
    v = _normal(rng, (b, h, t, dv), cuda, dtype)
    g = torch.from_numpy(-rng.uniform(0.0, 0.3, (b, h, t, dk)).astype(np.float32))
    g[..., :3, :] = -9.0                              # clamped to -8
    g = g.to(cuda).to(dtype)
    before = gla_chunked.launches  # one per call: three kernels each
    o, s = gla_chunked(q, k, v, g)
    o2, s2 = gla_chunked(q, k, v, g)
    torch.cuda.synchronize()
    assert gla_chunked.launches == before + 2
    assert torch.equal(o, o2) and torch.equal(s, s2)
    assert o.dtype == dtype and s.dtype == torch.float32
    wo, ws = gla_chunked_ref(q, k, v, g)
    tol = 2e-2 if dtype == torch.bfloat16 else 3e-3
    torch.testing.assert_close(o.float(), wo.float(), rtol=tol, atol=tol)
    torch.testing.assert_close(s, ws, rtol=3e-3, atol=3e-3)
