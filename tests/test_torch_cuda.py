"""The hand-written CUDA kernels on the card: against their plain PyTorch
versions, bitwise stable between launches, and counted.

Marked ``cuda``; each test skips where no CUDA card is present.  Run on a
machine with one: ``PYTHONPATH=src python -m pytest -q -m cuda tests/``.
"""

import numpy as np
import pytest
import torch

from repro_torch.api import Session, SessionConfig
from repro_torch.engine.datagen import tpch_catalog
from repro_torch.kernels.block_agg import (block_agg, block_agg_batched,
                                           block_agg_batched_ref, block_agg_ref)
from repro_torch.kernels.filtered_agg import (filtered_agg, filtered_agg_batched,
                                              filtered_agg_batched_ref,
                                              filtered_agg_ref)
from repro_torch.kernels.segment_sum import ops as segment_ops
from repro_torch.kernels.segment_sum import segment_sum, segment_sum_ref
from repro_torch.kernels.taqa_solve import (taqa_draw_compact, taqa_draw_compact_ref,
                                            taqa_solve_rate, taqa_solve_rate_ref)
from repro_torch.kernels.taqa_solve import ops as taqa_ops
from repro_torch.kernels.graph_nodes import captured_node_types
from segment_sum_mirror import mirror_few, mirror_slab, slab_keys
from taqa_solve_mirror import solve_mirror

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


# n_phys: one block; fewer than a warp's slots; a ragged tail of k-blocks
# (101 = 3 CTAs of 4 x 8 blocks and 5); a large final (65,536)
@pytest.mark.parametrize("block_rows", [32, 100, 256])
@pytest.mark.parametrize("n_phys", [1, 7, 101, 65_536])
def test_solo_kernels_agree_at_every_blocks_per_warp(cuda, n_phys, block_rows):
    """The redesigned solo kernels at every blocks-per-warp k: bitwise one
    output, bitwise a lane of the batched kernel (the same per-row step and
    butterflies), and against the plain versions (counts exact, sums rtol
    1e-5, min/max exact with the NaN sentinel).  Covers Q6's aliasing (f1
    and f3 one int32 column, f2 = y), y absent (SUM(col)), a bool x,
    COUNT-only (valid as the value column), an empty block, repeated ids
    and zero padding."""
    from repro_torch.kernels import column_launch
    from repro_torch.kernels.block_agg import ops as block_ops
    from repro_torch.kernels.filtered_agg import ops as filtered_ops
    price, discount, shipdate, valid, _ = _columns(block_rows, 500, cuda, 4)
    rng = np.random.default_rng(n_phys + block_rows)
    ids = rng.integers(0, 500, n_phys).astype(np.int32)
    ids[0] = 0                                      # the empty block
    if n_phys >= 7:
        ids[1:3] = ids[3]                           # repeated ids
        ids[-2:] = 0                                # zero padding
    ids = torch.from_numpy(ids).to(cuda)
    bounds = torch.tensor([100.0, 1500.0, 0.02, 0.08, 2000.0],
                          dtype=torch.float32, device=cuda)
    q6 = (price, discount, shipdate, discount, shipdate, valid, block_rows)
    sum_x = (price, None, shipdate, discount, shipdate, valid, block_rows)
    bool_x = (valid, price, shipdate, discount, shipdate, valid, block_rows)
    ks = column_launch.BLOCKS_PER_WARP
    for cols in (q6, sum_x, bool_x):
        outs = [filtered_ops.launch(*cols, ids, bounds, k) for k in ks]
        for out in outs[1:]:
            assert torch.equal(_bits(out), _bits(outs[0]))
        lane = filtered_agg_batched(*cols, ids[None].contiguous(), bounds[None].contiguous())
        assert torch.equal(_bits(lane[0]), _bits(outs[0]))
        ref = filtered_agg_ref(*cols, ids, bounds)
        assert torch.equal(outs[0][:, 0], ref[:, 0])
        torch.testing.assert_close(outs[0][:, 1:], ref[:, 1:], rtol=1e-5, atol=0)
    for col in (price, shipdate, valid):
        outs = [block_ops.launch(col, valid, block_rows, ids, k) for k in ks]
        for out in outs[1:]:
            assert torch.equal(_bits(out), _bits(outs[0]))
        lane = block_agg_batched(col, valid, block_rows, ids[None].contiguous())
        assert torch.equal(_bits(lane[0]), _bits(outs[0]))
        ref = block_agg_ref(col, valid, block_rows, ids)
        assert torch.equal(outs[0][:, 0], ref[:, 0])
        torch.testing.assert_close(outs[0][:, 1:3], ref[:, 1:3], rtol=1e-5, atol=0)
        torch.testing.assert_close(outs[0][:, 3:], ref[:, 3:], rtol=0, atol=0,
                                   equal_nan=True)
        assert bool(torch.isnan(outs[0][0, 3]))     # block 0 has no valid row


# batch 1 (a solo call's shape), 3 and 8 lanes; n_phys as above
@pytest.mark.parametrize("block_rows", [32, 100, 256])
@pytest.mark.parametrize("n_phys", [1, 7, 101, 65_536])
@pytest.mark.parametrize("batch", [1, 3, 8])
def test_batched_kernels_agree_at_every_blocks_per_warp(cuda, batch, n_phys,
                                                        block_rows):
    """One kernel serves solo and batched calls: a (B, n_phys) launch at
    every blocks-per-warp k is bitwise one output, each lane is bitwise the
    solo launch on its ids and bounds, and the result holds to the plain
    version (counts exact, sums rtol 1e-5, min/max exact with the NaN
    sentinel).  Covers Q6's aliasing, y absent, a bool x, COUNT-only, an
    empty block, repeated ids and zero padding; each lane its own bounds."""
    from repro_torch.kernels import column_launch
    from repro_torch.kernels.block_agg import ops as block_ops
    from repro_torch.kernels.filtered_agg import ops as filtered_ops
    price, discount, shipdate, valid, _ = _columns(block_rows, 500, cuda, 6)
    rng = np.random.default_rng(batch * n_phys + block_rows)
    ids = rng.integers(0, 500, (batch, n_phys)).astype(np.int32)
    ids[:, 0] = 0                                   # the empty block
    if n_phys >= 7:
        ids[:, 1:3] = ids[:, 3:4]                   # repeated ids
        ids[-1, -2:] = 0                            # zero padding
    ids = torch.from_numpy(ids).to(cuda)
    lo = rng.uniform(0.0, 0.03, batch)
    bounds = torch.from_numpy(np.stack(
        [np.full(batch, 100.0), np.full(batch, 1500.0), lo, lo + 0.05,
         rng.uniform(500.0, 2500.0, batch)], axis=1).astype(np.float32)).to(cuda)
    ks = column_launch.BLOCKS_PER_WARP
    q6 = (price, discount, shipdate, discount, shipdate, valid, block_rows)
    sum_x = (price, None, shipdate, discount, shipdate, valid, block_rows)
    bool_x = (valid, price, shipdate, discount, shipdate, valid, block_rows)
    for cols in (q6, sum_x, bool_x):
        outs = [filtered_ops.launch(*cols, ids, bounds, k) for k in ks]
        for out in outs[1:]:
            assert torch.equal(_bits(out), _bits(outs[0]))
        assert torch.equal(_bits(filtered_agg_batched(*cols, ids, bounds)),
                           _bits(outs[0]))
        for b in range(batch):
            solo = filtered_agg(*cols, ids[b].contiguous(), bounds[b].contiguous())
            assert torch.equal(_bits(outs[0][b]), _bits(solo))
        ref = filtered_agg_batched_ref(*cols, ids, bounds)
        assert torch.equal(outs[0][..., 0], ref[..., 0])
        torch.testing.assert_close(outs[0][..., 1:], ref[..., 1:], rtol=1e-5, atol=0)
    for col in (price, shipdate, valid):
        outs = [block_ops.launch(col, valid, block_rows, ids, k) for k in ks]
        for out in outs[1:]:
            assert torch.equal(_bits(out), _bits(outs[0]))
        assert torch.equal(_bits(block_agg_batched(col, valid, block_rows, ids)),
                           _bits(outs[0]))
        for b in range(batch):
            solo = block_agg(col, valid, block_rows, ids[b].contiguous())
            assert torch.equal(_bits(outs[0][b]), _bits(solo))
        ref = block_agg_batched_ref(col, valid, block_rows, ids)
        assert torch.equal(outs[0][..., 0], ref[..., 0])
        torch.testing.assert_close(outs[0][..., 1:3], ref[..., 1:3], rtol=1e-5, atol=0)
        torch.testing.assert_close(outs[0][..., 3:], ref[..., 3:], rtol=0, atol=0,
                                   equal_nan=True)
        assert bool(torch.isnan(outs[0][:, 0, 3]).all())  # block 0 has no valid row


def test_solo_kernels_refuse_an_uninstantiated_blocks_per_warp(cuda):
    from repro_torch.kernels.filtered_agg import ops as filtered_ops
    price, discount, shipdate, valid, ids = _columns(32, 50, cuda, 5)
    bounds = torch.zeros(5, dtype=torch.float32, device=cuda)
    with pytest.raises(ValueError, match="blocks_per_warp"):
        filtered_ops.launch(price, discount, shipdate, discount, shipdate,
                            valid, 32, ids, bounds, 3)
    with pytest.raises(ValueError, match="blocks_per_warp"):
        filtered_ops.launch(price, discount, shipdate, discount, shipdate,
                            valid, 32, ids[None].contiguous(), bounds[None].contiguous(), 8)


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


# -- the gather route: segment_sum ------------------------------------------------

# (channels, rows, segments): keys drawn over fewer ids than segments, so
# some segments are empty; one run longer than many 1,024-row chunks; S >> R
# (a join pilot's pair sums); C = 1 and 5; more channels than one pass keeps;
# above 2^24 rows, where chunks are 4,096 rows (segments of ~4,500 rows)
SEGMENT_CASES = [(5, 40_000, 60), (2, 3 * 4096 * 5 + 17, 3), (2, 32_768, 10_000_000),
                 (1, 5_000, 7), (5, 30_000, 1), (9, 20_000, 100),
                 (1, (1 << 24) + 1_000, 5_000)]


@pytest.mark.parametrize("case", SEGMENT_CASES, ids=lambda c: f"{c[0]}x{c[1]}->{c[2]}")
def test_segment_sum_matches_plain_version_on_the_card(cuda, case):
    """Against the plain version on the CPU (row-order index_add_) at rtol
    1e-5: the kernel adds each segment in 1,024- or 4,096-row chunks,
    lanes strided, so the last bits differ.  Price-like positive values, so
    the relative tolerance means what it says; at most ~30k rows per
    segment, where row order's own f32 error stays near 3e-6.  Two launches
    bitwise equal; empty segments exactly 0."""
    c, r, nseg = case
    rng = np.random.default_rng(r)
    vals = torch.from_numpy(rng.uniform(900.0, 1100.0, (c, r)).astype(np.float32))
    keys = rng.integers(0, max(nseg - nseg // 4, 1), r)
    seg = torch.from_numpy(keys)
    launches = segment_sum.launches
    got = segment_sum(vals.to(cuda), seg.to(cuda), nseg)
    again = segment_sum(vals.to(cuda), seg.to(cuda), nseg)
    torch.cuda.synchronize()
    assert segment_sum.launches == launches + 2
    assert torch.equal(got.view(torch.int32), again.view(torch.int32))
    got = got.cpu()
    plain = segment_sum_ref(vals, seg, nseg)
    torch.testing.assert_close(got, plain, rtol=1e-5, atol=0)
    empty = torch.ones(nseg, dtype=torch.bool)
    empty[seg] = False
    assert not got[:, empty].any()


def test_segment_sum_drops_keys_out_of_range_on_the_card(cuda):
    """A key outside [0, S) is dropped on the card, as the plain version on
    the CPU drops it."""
    seg = torch.tensor([0, 1, 2, -1, 3, 99, 2], dtype=torch.int64)
    vals = torch.ones((2, 7), dtype=torch.float32)
    got = segment_sum(vals.to(cuda), seg.to(cuda), 3)
    assert got.cpu().tolist() == [[1.0, 1.0, 2.0]] * 2
    assert torch.equal(got.cpu(), segment_sum(vals, seg, 3))


def _f32_bound(vals, seg, nseg):
    """2 n u sum|x| per segment: two f32 sums of the same n values in
    different orders lie within it of each other."""
    keep = (seg >= 0) & (seg < nseg)
    absum = torch.zeros((vals.shape[0], nseg), dtype=torch.float64).index_add_(
        1, seg[keep], vals[:, keep].double().abs())
    n = torch.zeros(nseg, dtype=torch.float64).index_add_(
        0, seg[keep], torch.ones(int(keep.sum()), dtype=torch.float64))
    return 2 * n * 2.0 ** -24 * absum


def _hold_route(cuda, vals, seg, nseg, want, mirror, **claim):
    """One call on the card: its route is ``want``; two launches bitwise
    equal and one launch each; bitwise the numpy mirror of its order; within
    rtol 1e-5 of the plain version; within the f32 bound of the sorted
    route's own sums on the same inputs; empty segments exactly 0."""
    c, r = vals.shape
    plan = segment_ops.launch_plan(c, r, nseg, claim.get("slab_rows"),
                                   claim.get("slab_keys"))
    assert (plan.route, plan.variant) == want
    launches = segment_sum.launches
    got = segment_sum(vals.to(cuda), seg.to(cuda), nseg, **claim)
    again = segment_sum(vals.to(cuda), seg.to(cuda), nseg, **claim)
    sorted_route = segment_ops.launch(vals.to(cuda), seg.to(cuda), nseg, force="sorted")
    torch.cuda.synchronize()
    assert segment_sum.launches == launches + 3
    assert torch.equal(got.view(torch.int32), again.view(torch.int32))
    got = got.cpu()
    assert torch.equal(got.view(torch.int32),
                       torch.from_numpy(mirror(vals.numpy(), seg.numpy())).view(torch.int32))
    plain = segment_sum_ref(vals, seg, nseg, **claim)
    torch.testing.assert_close(got, plain, rtol=1e-5, atol=0)
    bound = _f32_bound(vals, seg, nseg)
    assert bool(((got.double() - sorted_route.cpu().double()).abs() <= bound).all())
    empty = torch.ones(nseg, dtype=torch.bool)
    empty[seg[(seg >= 0) & (seg < nseg)]] = False
    assert not got[:, empty].any()


# (channels, block_rows, W, slabs): the pilot block sums (W 1), the Q1
# pilot (W 3), a join pilot's pair sums (W > 32, the zero-filled output; a
# narrower right table than SF10's 468,750 blocks, so the numpy mirror and
# the f64 bound stay small), 100-row blocks (several steps a slab), more
# channels than a pass keeps
SLAB_CARD_CASES = [(3, 32, 1, 1_025), (5, 32, 3, 4_096), (2, 32, 2_000, 1_025),
                   (4, 100, 7, 300), (9, 256, 2, 64)]


@pytest.mark.parametrize("case", SLAB_CARD_CASES, ids=lambda c: f"{c[0]}ch-br{c[1]}-W{c[2]}")
def test_segment_sum_slab_route_on_the_card(cuda, case):
    """The slab route against its mirror (bitwise), its plain version and
    the sorted route, with scratch rows past the slabs dropped."""
    c, br, w, slabs = case
    rng = np.random.default_rng(slabs + w)
    rows = slabs * br + br // 2
    nseg = slabs * w
    seg = slab_keys(rng, rows, br, w, nseg, slabs * br)
    vals = torch.from_numpy(rng.uniform(900.0, 1100.0, (c, rows)).astype(np.float32))
    _hold_route(cuda, vals, torch.from_numpy(seg), nseg,
                ("slab", "lane" if w <= 32 else "wide"),
                lambda v, k: mirror_slab(v, k, nseg, br, w), slab_rows=br, slab_keys=w)


# (channels, rows, segments): the finals and exact scans (S 1 and 3, the
# lane form), S 4 at its edge, a pilot with no slab claim (S 1,025, the warp
# form in shared memory), ranges past the range pass's 256 threads
FEW_CARD_CASES = [(2, 8_192, 1), (5, 65_536, 3), (3, 65_536, 1), (4, 9_000, 4),
                  (3, 32_768 + 100, 1_025), (2, 300 * 256 + 5, 3), (9, 5_000, 2)]


@pytest.mark.parametrize("case", FEW_CARD_CASES, ids=lambda c: f"{c[0]}x{c[1]}->{c[2]}")
def test_segment_sum_few_route_on_the_card(cuda, case):
    """The few route against its mirror (bitwise), its plain version and the
    sorted route; keys -1 and S dropped."""
    c, rows, nseg = case
    rng = np.random.default_rng(rows + nseg)
    seg = torch.from_numpy(rng.integers(0, nseg + 2, rows) - 1)
    vals = torch.from_numpy(rng.uniform(900.0, 1100.0, (c, rows)).astype(np.float32))
    _hold_route(cuda, vals, seg, nseg, ("few", "lane" if nseg <= 4 else "warp"),
                lambda v, k: mirror_few(v, k, nseg)[0])


def test_segment_sum_exact_scan_shape_on_the_card(cuda):
    """The exact Q1's shape at 2^25 rows (ranges of 8,192 rows): one read,
    within rtol 1e-5 of an f64 sum, bitwise stable."""
    rows, nseg = 1 << 25, 3
    g = torch.Generator(device="cuda").manual_seed(0)
    vals = torch.rand((5, rows), generator=g, device=cuda) * 200 + 900
    seg = torch.randint(0, nseg, (rows,), generator=g, device=cuda)
    assert segment_ops.launch_plan(5, rows, nseg) == ("few", "lane", (512, 15))
    got = segment_sum(vals, seg, nseg)
    assert torch.equal(got.view(torch.int32), segment_sum(vals, seg, nseg).view(torch.int32))
    want = torch.zeros((5, nseg), dtype=torch.float64, device=cuda).index_add_(
        1, seg, vals.double())
    torch.testing.assert_close(got.double(), want, rtol=1e-5, atol=0)


def test_gather_sessions_on_the_card_match_the_cpu(cuda):
    """The grouped, join and Q14 queries of examples/aqp_analytics.py on the
    card and on the CPU: equal pilot sizes and fallbacks, rates within
    rtol 1e-6, answers within rtol 1e-5."""
    guarantee = " ERROR 15% CONFIDENCE 90%"
    queries = [
        "SELECT SUM(l_quantity) AS qty, AVG(l_extendedprice) AS avg_price, "
        "COUNT(*) AS orders FROM lineitem GROUP BY l_returnflag",
        "SELECT SUM(l_extendedprice) AS rev FROM lineitem "
        "JOIN orders ON l_orderkey = o_orderkey WHERE o_orderdate < 1200",
        "SELECT SUM(l_extendedprice * l_discount * l_linestatus) / "
        "SUM(l_extendedprice * l_discount) AS promo_share FROM lineitem "
        "WHERE l_shipdate BETWEEN 400 AND 2200"]
    launches = segment_sum.launches
    out = {}
    for dev in ("cuda", "cpu"):
        s = Session(tpch_catalog(200_000, 32, seed=0, device=dev), seed=7,
                    device=dev)
        out[dev] = [s.sql(q + guarantee) for q in queries] + [s.sql(q) for q in queries]
    assert segment_sum.launches > launches
    for g, c in zip(out["cuda"], out["cpu"]):
        assert g.status == c.status == "done"
        assert g.fallback == c.fallback
        assert g.report.n_pilot_blocks == c.report.n_pilot_blocks
        assert (g.report.plan is None) == (c.report.plan is None)
        if g.report.plan is not None:
            for t, rate in g.report.plan.rates.items():
                assert rate == pytest.approx(c.report.plan.rates[t], rel=1e-6)
        np.testing.assert_allclose(g.answer.values, c.answer.values, rtol=1e-5)


def test_cuda_grouped_drain_is_bitwise_the_serial_session(cuda):
    """A grouped herd on the card: one solo pilot per member, its finals
    run gather_batched, and every answer is bitwise an equal-seed serial
    session's Session.sql."""
    from repro_torch.api import SessionConfig
    cat = tpch_catalog(200_000, 32, seed=0, device="cuda")
    herd = [f"SELECT SUM(l_quantity) AS qty, COUNT(*) AS n FROM lineitem "
            f"WHERE l_shipdate < {x} GROUP BY l_returnflag ERROR 15% CONFIDENCE 90%"
            for x in (1800, 2000, 2200, 2400)]
    s = Session(cat, seed=7, config=SessionConfig(result_cache_size=0))
    routes = []
    compile_batched = s.executor.physical.compile_batched_query

    def spy(*a, **kw):
        c = compile_batched(*a, **kw)
        routes.append(c.route)
        return c

    s.executor.physical.compile_batched_query = spy
    hs = [s.submit(q) for q in herd]
    s.drain()
    serial = Session(cat, seed=7, config=SessionConfig(
        async_workers=0, share_pilots=False, result_cache_size=0))
    try:
        assert "gather_batched" in routes
        for h, q in zip(hs, herd):
            r = serial.sql(q)
            assert h.status == r.status == "done"
            np.testing.assert_array_equal(h.answer.values, r.answer.values)
    finally:
        s.close()
        serial.close()


# -- staged ladders and shards on the card -----------------------------------------

def _staged_plans():
    """The grouped Q1 (gather route), Q6 (filtered_agg) and SUM/COUNT
    (block_agg) as engine plans, block-sampled by ``sample(plan, rate)``."""
    from repro_torch.engine import logical as L
    from repro_torch.engine.expr import And, Col
    q6_pred = And(Col("l_shipdate").between(100, 1500),
                  Col("l_discount").between(0.02, 0.08))
    plans = {
        "q1": L.Aggregate(child=L.Scan("lineitem"),
                          aggs=(L.AggSpec("sum", Col("l_quantity"), "qty"),
                                L.AggSpec("count", None, "n")),
                          group_by="l_returnflag", max_groups=3),
        "q6": L.Aggregate(child=L.Filter(L.Scan("lineitem"), q6_pred),
                          aggs=(L.AggSpec("sum", Col("l_extendedprice") * Col("l_discount"),
                                          "revenue"),)),
        "sum_count": L.Aggregate(child=L.Scan("lineitem"),
                                 aggs=(L.AggSpec("sum", Col("l_extendedprice"), "s"),
                                       L.AggSpec("count", None, "n"))),
    }
    sample = lambda plan, rate, seed=5: L.rewrite_scans(
        plan, {"lineitem": L.SampleClause("block", rate, seed)})
    return plans, sample, L.strip_samples


def _bits64(a):
    return np.asarray(a, np.float64).view(np.int64)


def test_staged_matches_fresh_bitwise_on_the_card(cuda):
    """Q6, SUM/COUNT and the grouped Q1 served from rungs on the card are
    bitwise the fresh draw (a ladder that never serves), finals and pilots,
    and take the same route as the fresh plan: the column kernels and
    segment_sum over the rung's tensors at block positions."""
    from repro_torch.engine.executor import Executor
    from repro_torch.engine.staged import prepare_mono_subdraw
    from repro_torch.engine.physical import ScanRuntime
    cat = tpch_catalog(200_000, 32, seed=0, device="cuda")
    plans, sample, strip = _staged_plans()
    fresh = Executor(dict(cat))
    fresh.register_staged("lineitem", [1e-9], seed=9)
    hot = Executor(dict(cat))
    hot.register_staged("lineitem", [0.01, 0.04, 0.16], seed=9)
    routes = {"q1": "gather", "q6": "filtered_agg", "sum_count": "block_agg"}
    launches = (filtered_agg.launches, block_agg.launches, segment_sum.launches)
    for name, plan in plans.items():
        for rate in (0.003, 0.03, 0.15):
            p = sample(plan, rate)
            a, b = hot.execute(p), fresh.execute(p)
            assert np.array_equal(_bits64(a.values), _bits64(b.values)), (name, rate)
            np.testing.assert_array_equal(a.sample_infos["lineitem"].sampled_block_ids,
                                          b.sample_infos["lineitem"].sampled_block_ids)
            lad = hot.staged.ladder("lineitem")
            rung = lad.rung_for(rate)
            sub = prepare_mono_subdraw(lad, rung, rate)
            rt = ScanRuntime("block", sub.n_real, sub.n_phys, sub.phys,
                             ids_dev=sub.phys_dev, nreal_dev=sub.nreal_dev)
            rts, _ = fresh._scan_runtimes(p)
            assert fresh.physical.compile_query(p, rts).route == routes[name]
            assert rung.compiler.compile_query(p, {"lineitem": rt}).route == routes[name]
            pa = hot.execute_pilot(strip(p), "lineitem", rate, 1)
            pb = fresh.execute_pilot(strip(p), "lineitem", rate, 1)
            assert np.array_equal(_bits64(pa.block_sums), _bits64(pb.block_sums))
    torch.cuda.synchronize()
    assert hot.staged.misses == 0 and hot.staged.hits == 18
    moved = (filtered_agg.launches - launches[0], block_agg.launches - launches[1],
             segment_sum.launches - launches[2])
    assert all(m > 0 for m in moved), moved


def test_staged_subdraw_past_the_rung_blocks_on_the_card(cuda):
    """A sub-draw whose fresh n_phys exceeds the rung's block count: the
    kernels read only positions inside the rung, and the answer is bitwise
    the fresh draw's."""
    from repro_torch.engine.executor import Executor
    from repro_torch.engine.staged import prepare_mono_subdraw
    cat = tpch_catalog(200_000, 32, seed=0, device="cuda")
    plans, sample, strip = _staged_plans()
    fresh = Executor(dict(cat))
    fresh.register_staged("lineitem", [1e-9], seed=9)
    hot = Executor(dict(cat))
    hot.register_staged("lineitem", [0.16], seed=9)
    lad = hot.staged.ladder("lineitem")
    rate = 0.15
    sub = prepare_mono_subdraw(lad, lad.rung_for(rate), rate)
    assert sub.n_phys > lad.rung_for(rate).table.num_blocks
    for plan in plans.values():
        p = sample(plan, rate)
        assert np.array_equal(_bits64(hot.execute(p).values),
                              _bits64(fresh.execute(p).values))
        assert np.array_equal(
            _bits64(hot.execute_pilot(strip(p), "lineitem", rate, 1).block_sums),
            _bits64(fresh.execute_pilot(strip(p), "lineitem", rate, 1).block_sums))
    assert hot.staged.hits == 6


def test_shard_counts_answer_bitwise_on_the_card(cuda):
    """1 / 2 / 7 shards, fresh and staged per shard: bitwise one answer and
    one set of pilot statistics; within rtol 1e-5 of the monolithic
    device reduction."""
    from repro_torch.dist import DistExecutor
    from repro_torch.engine.executor import Executor
    cat = tpch_catalog(200_000, 32, seed=0, device="cuda")
    plans, sample, strip = _staged_plans()
    mono = Executor(dict(cat))
    mono.register_staged("lineitem", [1e-9], seed=9)  # the same pinned draw
    for name, plan in plans.items():
        p = sample(plan, 0.03)
        want = mono.execute(p).values
        got = {}
        for rates in ([1e-9], [0.04]):
            for n in (1, 2, 7):
                ex = DistExecutor(dict(cat))
                ex.register_sharded("lineitem", cat["lineitem"], n)
                ex.register_staged("lineitem", rates, seed=9)
                got[(rates[0], n)] = (ex.execute(p).values,
                                      ex.execute_pilot(strip(p), "lineitem", 0.03, 1).block_sums)
        first = got[(1e-9, 1)]
        for key, (v, bs) in got.items():
            assert np.array_equal(_bits64(v), _bits64(first[0])), (name, key)
            assert np.array_equal(_bits64(bs), _bits64(first[1])), (name, key)
        np.testing.assert_allclose(first[0], want, rtol=1e-5)


def test_shards_round_robin_over_cards_answer_bitwise(cuda):
    """Shards placed round-robin over every visible card (it needs two or
    more): each shard's tensors and its executor's replicated tables on its
    own card, and the answers and pilot statistics bitwise those of the
    same shard count on one card, fresh and staged."""
    from repro_torch.dist import DistExecutor
    n_cards = torch.cuda.device_count()
    if n_cards < 2:
        pytest.skip("needs two or more CUDA cards; one card is covered by "
                    "test_shard_counts_answer_bitwise_on_the_card")
    cards = [torch.device("cuda", i) for i in range(n_cards)]
    cat = tpch_catalog(200_000, 32, seed=0, device="cuda:0")
    plans, sample, strip = _staged_plans()
    out = {}
    for devices in (None, cards):
        for rates in ([1e-9], [0.04]):
            ex = DistExecutor(dict(cat), device="cuda:0")
            st = ex.register_sharded("lineitem", cat["lineitem"], 2 * n_cards,
                                     devices=devices)
            ex.register_staged("lineitem", rates, seed=9)
            if devices is not None:
                assert [s.table.device for s in st.shards] == \
                    [cards[i % n_cards] for i in range(2 * n_cards)]
            for name, plan in plans.items():
                p = sample(plan, 0.03)
                out[(devices is None, rates[0], name)] = (
                    ex.execute(p).values,
                    ex.execute_pilot(strip(p), "lineitem", 0.03, 1).block_sums)
    for (one_card, rate, name), (v, bs) in out.items():
        want = out[(True, 1e-9, name)]
        assert np.array_equal(_bits64(v), _bits64(want[0])), (one_card, rate, name)
        assert np.array_equal(_bits64(bs), _bits64(want[1])), (one_card, rate, name)


def test_sharded_join_pilot_pair_sums_merge_bitwise_on_the_card(cuda):
    """The join pilot's per-(pilot block, right block) sums over 3 shards
    concatenate to the monolithic pilot's, bit for bit."""
    from repro_torch.dist import DistExecutor
    from repro_torch.engine import logical as L
    from repro_torch.engine.executor import Executor
    from repro_torch.engine.expr import Col
    cat = tpch_catalog(40_000, 32, seed=0, device="cuda")
    plan = L.Aggregate(
        child=L.Join(L.Scan("lineitem"), L.Scan("orders"), "l_orderkey", "o_orderkey"),
        aggs=(L.AggSpec("sum", Col("l_extendedprice"), "rev"),))
    ref = Executor(dict(cat)).execute_pilot(plan, "lineitem", 0.05, 11,
                                            pair_tables=("orders",))
    ex = DistExecutor(dict(cat))
    ex.register_sharded("lineitem", cat["lineitem"], 3)
    ps = ex.execute_pilot(plan, "lineitem", 0.05, 11, pair_tables=("orders",))
    assert ps.n_sampled_blocks == ref.n_sampled_blocks > 0
    assert np.array_equal(_bits64(ps.block_sums), _bits64(ref.block_sums))
    assert np.array_equal(_bits64(ps.pair_sums["orders"]), _bits64(ref.pair_sums["orders"]))


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


def _pilot_inputs(n_phys, n_real, seed, dev, n_solve=2):
    """Pilot-shaped solve inputs: n_solve block-sum channels (revenue-like
    and price-like in turn) and a row-count channel, zero past n_real, with
    Q6-like quantile rows and an SF10-like cost line."""
    rng = np.random.default_rng(seed)
    bs = np.zeros((n_phys, n_solve + 1), np.float32)
    for c in range(n_solve):
        bs[:n_real, c] = (rng.gamma(2.0, 5_000.0, n_real) if c % 2 == 0
                          else rng.normal(1.2e6, 1e5, n_real))
    bs[:n_real, n_solve] = 32.0
    solve = np.tile(np.array([2.6, 0.9 * (n_real - 1), 2.2, 2.8, 0.05], np.float32),
                    (n_solve, 1))
    scal = np.array([1_875_000, 1.0, 1e-6, 1.5e9, 2e5, 1.6e9], np.float32)
    t = lambda a: torch.from_numpy(a).to(dev)
    return (t(bs), t(np.array([True])), n_real, t(np.arange(n_solve, dtype=np.int32)),
            t(solve), t(scal))


@pytest.mark.parametrize("n_solve", [1, 2, 8, 64])
@pytest.mark.parametrize("n_phys,n_real", [(64, 2), (2048, 1400), (4096, 4096), (300, 299),
                                           (65_536, 65_536), (65_536, 1_024)])
def test_taqa_solve_rate_bitwise_its_plain_version(cuda, n_phys, n_real, n_solve):
    """Bitwise the plain version's sequential loop and the numpy mirror of
    the kernel's speculative rounds."""
    args = _pilot_inputs(n_phys, n_real, n_real, cuda, n_solve)
    launches = taqa_solve_rate.launches
    theta, flags = taqa_solve_rate(*args)
    again, _ = taqa_solve_rate(*args)
    ref_theta, ref_flags = taqa_solve_rate_ref(*args)
    torch.cuda.synchronize()
    assert taqa_solve_rate.launches == launches + 2
    assert torch.equal(theta.view(torch.int32), again.view(torch.int32))
    assert torch.equal(theta.view(torch.int32), ref_theta.view(torch.int32))
    assert torch.equal(flags, ref_flags)
    host = [a.cpu().numpy() if torch.is_tensor(a) else a for a in args]
    mirror_theta, mirror_flags = solve_mirror(*host)
    assert np.array_equal(theta.cpu().numpy().view(np.int32), mirror_theta.view(np.int32))
    assert int(flags[0]) == mirror_flags


@pytest.mark.parametrize("n", [1, 4095, 4096, 4097, 16_383, 16_384, 16_385, 100_000, 1_875_000,
                               18_750_000])
def test_taqa_draw_compact_equals_its_plain_version(cuda, n):
    """Equal to the plain version for every theta, one kernel launch per
    call (a CUDA graph of the call holds one kernel node and nothing else);
    at 18,750,000 uniforms the 1,145 tiles outnumber the resident CTAs."""
    u = torch.from_numpy(np.random.default_rng(n).random(n).astype(np.float32)).to(cuda)
    for theta in (0.0, 0.0005, 0.3, 1.0, 2.0):
        th = torch.tensor([theta], dtype=torch.float32, device=cuda)
        launches = taqa_draw_compact.launches
        nsel, padded = taqa_draw_compact(u, th)
        assert taqa_draw_compact.launches == launches + 1
        ref_nsel, ref_padded = taqa_draw_compact_ref(u, th)
        assert torch.equal(nsel, ref_nsel) and torch.equal(padded, ref_padded)
    th = torch.tensor([0.3], dtype=torch.float32, device=cuda)
    assert captured_node_types(lambda: taqa_draw_compact(u, th)) == ["kernel"]


def test_taqa_draw_compact_on_one_scratch_across_sizes_and_the_epoch_wrap(cuda):
    """Calls of shrinking and growing size on one stream's scratch (stale
    statuses never count), then across the epoch wrap: the launch of the
    last epoch clears every status and the epochs start again at 1."""
    dev = torch.device("cuda", torch.cuda.current_device())  # the index a tensor carries
    scratch = taqa_ops._draw_scratch(dev, torch.cuda.current_stream(dev).cuda_stream)
    rng = np.random.default_rng(8)

    def check(n, theta):
        u = torch.from_numpy(rng.random(n).astype(np.float32)).to(cuda)
        th = torch.tensor([theta], dtype=torch.float32, device=cuda)
        nsel, padded = taqa_draw_compact(u, th)
        ref_nsel, ref_padded = taqa_draw_compact_ref(u, th)
        assert torch.equal(nsel, ref_nsel) and torch.equal(padded, ref_padded)

    for n in (18_750_000, 100_000, 1_875_000, 17, 18_750_000):
        check(n, float(rng.choice([0.0005, 0.3])))
    last = 2 ** 32 - 1
    scratch[0] = ((last - 1) << 32) - 2 ** 64           # epoch last - 1, ticket 0 (as int64)
    check(1_875_000, 0.3)
    check(2_000_000, 0.0005)                             # the wrap launch
    torch.cuda.synchronize()
    assert int(scratch[0]) == 1 << 32 and int(scratch[1]) == 0
    assert not scratch[2:].any()
    for n in (18_750_000, 4097):
        check(n, 0.3)
    assert int(scratch[0]) == 3 << 32


def test_taqa_kernels_give_the_same_bits_launch_to_launch(cuda):
    """20 launches of each kernel on one input: one set of bits, and each
    call is one kernel node."""
    args = _pilot_inputs(2048, 1400, 5, cuda, 2)
    first = taqa_solve_rate(*args)
    for _ in range(19):
        again = taqa_solve_rate(*args)
        assert torch.equal(again[0].view(torch.int32), first[0].view(torch.int32))
        assert torch.equal(again[1], first[1])
    assert captured_node_types(lambda: taqa_solve_rate(*args)) == ["kernel"]
    u = torch.from_numpy(np.random.default_rng(3).random(1_875_000)
                         .astype(np.float32)).to(cuda)
    th = torch.tensor([0.01], dtype=torch.float32, device=cuda)
    nsel, padded = taqa_draw_compact(u, th)
    for _ in range(19):
        n2, p2 = taqa_draw_compact(u, th)
        assert torch.equal(n2, nsel) and torch.equal(p2, padded)
    torch.cuda.synchronize()


def test_fused_session_on_the_card_is_bitwise_two_stage(cuda):
    cat = tpch_catalog(200_000, 32, seed=0)
    vals = {}
    for fused in (False, True):
        s = Session(cat, seed=7, config=SessionConfig(fused_taqa=fused,
                                                      result_cache_size=0))
        calls = taqa_solve_rate.launches, taqa_draw_compact.launches
        hs = [s.sql(q + " ERROR 10% CONFIDENCE 95%") for q in
              ("SELECT SUM(l_extendedprice * l_discount) AS r FROM lineitem "
               "WHERE l_shipdate BETWEEN 100 AND 1500 AND l_discount BETWEEN 0.02 AND 0.08",
               "SELECT SUM(l_extendedprice) AS s, COUNT(*) AS n FROM lineitem")]
        assert all(h.status == "done" for h in hs), [h.error for h in hs]
        launched = (taqa_solve_rate.launches - calls[0], taqa_draw_compact.launches - calls[1])
        assert launched == ((2, 2) if fused else (0, 0))
        assert [h._fused for h in hs] == [fused, fused]
        vals[fused] = [h.answer.values for h in hs]
        s.close()
    for a, b in zip(vals[False], vals[True]):
        np.testing.assert_array_equal(a, b)


# -- streaming, tracing, audit and telemetry on the card ---------------------------

def test_hooks_on_the_card_are_bitwise_the_hooks_off_session(cuda, tmp_path):
    """Every hook on (streams, traces, the audit, telemetry, the flight
    recorder) against every hook off, on the card: sql, a threaded drain
    and the fused program answer bitwise alike; each final frame is the
    answer; every audited answer keeps its promise; the replayed log
    rebuilds the live time-series."""
    from repro_torch.obs.events import rebuild_timeseries
    cat = tpch_catalog(200_000, 32, seed=0)
    q6 = ("SELECT SUM(l_extendedprice * l_discount) AS r FROM lineitem "
          "WHERE l_shipdate BETWEEN 100 AND 1500 AND l_discount BETWEEN 0.02 AND 0.08")
    sqls = [q6, "SELECT SUM(l_extendedprice) AS s, COUNT(*) AS n FROM lineitem",
            "SELECT SUM(l_quantity) AS q, COUNT(*) AS n FROM lineitem "
            "GROUP BY l_returnflag"]
    sqls = [q + " ERROR 10% CONFIDENCE 95%" for q in sqls]
    base = dict(result_cache_size=0, async_workers=2)
    hooks = dict(tracing=True, audit=True, telemetry=True, trace_sample=1.0,
                 flight_recorder=str(tmp_path / "ev.jsonl"))
    out = {}
    for tag, kw in (("off", base), ("on", {**base, **hooks})):
        s = Session(cat, seed=7, config=SessionConfig(**kw))
        solo = [s.sql(q, stream=tag == "on") for q in sqls]
        herd = [s.submit(q, stream=tag == "on") for q in sqls]
        s.drain()
        kw_f = {**kw, "fused_taqa": True}
        if tag == "on":
            kw_f["flight_recorder"] = str(tmp_path / "ev_fused.jsonl")
        f = Session(cat, seed=7, config=SessionConfig(**kw_f))
        fused = f.sql(sqls[0], stream=tag == "on")
        assert fused._fused
        out[tag] = (solo + herd + [fused], s, f)
        s.close()
        f.close()
    for a, b in zip(out["off"][0], out["on"][0]):
        assert a.status == b.status == "done", (a.error, b.error)
        np.testing.assert_array_equal(_bits64(a.answer.values), _bits64(b.answer.values))
        assert b.frames()[-1].answer is b.answer and b._trace.open_spans() == []
        assert b.audit_record is not None
        assert b.audit_record.observed_error <= b.audit_record.promised_error
    s = out["on"][1]
    rebuilt = rebuild_timeseries(str(tmp_path / "ev.jsonl"))
    for key in s.timeseries.keys():
        a, b = s.timeseries.series(key), rebuilt.series(key)
        assert (a.deliveries, a.shared, a.audited) == (b.deliveries, b.shared, b.audited)


# reduced hymba and granite-moe at head_dim 64 (and hymba's SSM state 16),
# the widths the flash and GLA kernels take; f32 on both devices
SERVE_CARD_CASES = {
    "hymba-1.5b": dict(head_dim=64, ssm_state=16, sliding_window=16),
    "granite-moe-1b-a400m": dict(head_dim=64),
}


def _small_model(arch, device, seed=5):
    from repro_torch.configs import get_config
    from repro_torch.models import Model
    cfg = get_config(arch).reduced(**SERVE_CARD_CASES[arch])
    cpu = Model(cfg, device="cpu").init(torch.Generator().manual_seed(seed))
    model = Model(cfg, device=device)
    model.load_state_dict(cpu.state_dict())
    return cpu, model


@pytest.mark.parametrize("arch", sorted(SERVE_CARD_CASES))
def test_prefill_and_decode_on_the_card_match_the_cpu(cuda, arch):
    """Prefill over 24 tokens (past hymba's ring of 16) through the flash
    and GLA kernels, then 16 decode steps, against the CPU port: logits
    within 1e-4 (f32 on both; the kernels' sums run in other orders)."""
    from repro_torch.kernels.flash_attn import flash_attention
    from repro_torch.kernels.gla_chunk import gla_chunked
    cpu, gpu = _small_model(arch, cuda)
    toks = torch.from_numpy(np.random.default_rng(1).integers(
        0, cpu.cfg.vocab_size, (2, 24)))
    launches = flash_attention.launches, gla_chunked.launches
    lc, cc = cpu.prefill({"tokens": toks}, cache_len=48)
    lg, cg = gpu.prefill({"tokens": toks.to(cuda)}, cache_len=48)
    torch.cuda.synchronize()
    L = cpu.cfg.num_layers
    assert flash_attention.launches - launches[0] == L
    assert gla_chunked.launches - launches[1] == (L if cpu.cfg.has_ssm else 0)
    torch.testing.assert_close(lg.cpu(), lc, rtol=1e-4, atol=1e-4)
    for t in range(16):
        tok = torch.full((2,), t, dtype=torch.int64)
        lc, cc = cpu.decode_step(cc, tok)
        lg, cg = gpu.decode_step(cg, tok.to(cuda))
        torch.testing.assert_close(lg.cpu(), lc, rtol=1e-4, atol=1e-4)
    assert torch.equal(cg["pos"].cpu(), cc["pos"])


def test_serve_engine_keeps_its_cache_storage_on_the_card(cuda):
    """The card's counterpart of one compiled graph: the engine's cache
    tensors keep their storage, shapes and dtypes across steps, runs and
    admissions; and the tokens are the CPU engine's on these weights."""
    from repro_torch.serve import ServeEngine
    cpu, gpu = _small_model("hymba-1.5b", cuda)
    engines = [ServeEngine(m, batch_slots=2, cache_len=32) for m in (cpu, gpu)]
    eng = engines[1]
    layout = {k: (v.data_ptr(), tuple(v.shape), v.dtype) for k, v in eng.cache.items()}
    outs = []
    for e in engines:
        e.submit([1, 2, 3], max_new_tokens=5)
        e.submit([4], max_new_tokens=3)
        e.submit([5, 6], max_new_tokens=4)  # admitted into a reused slot
        first = e.run()
        e.submit([7, 8], max_new_tokens=4)
        outs.append((first, e.run()))
    assert {k: (v.data_ptr(), tuple(v.shape), v.dtype)
            for k, v in eng.cache.items()} == layout
    assert all(v.device.type == "cuda" for v in eng.cache.values())
    assert outs[0] == outs[1]
