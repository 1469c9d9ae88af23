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
from repro_torch.kernels.block_draw import block_draw, block_draw_ref, pcg64_state
from repro_torch.kernels.block_draw import ops as block_draw_ops
from repro_torch.engine.sampling import (bucket_blocks, draw_block_ids, draw_block_ids_device,
                                         pad_block_ids)
from repro_torch.kernels.graph_nodes import captured_node_types
from segment_sum_mirror import mirror_few, mirror_slab, slab_keys
from taqa_solve_mirror import solve_mirror
from torch_parity import spec_batch

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
    """A grouped herd on the card: the members' pilots stack into one
    segment_sum launch, its finals run gather_batched, and every answer is
    bitwise an equal-seed serial session's Session.sql."""
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


# -- stacked pilots on the card ----------------------------------------------------

def _stacked_against_solo(session, sqls):
    """``run_pilots_batched`` over ``sqls`` (pilot seeds 100, 101, ...),
    then each member's solo ``run_pilot``: the stacked outcomes must be
    bitwise the solo ones.  Returns the executor's dispatches of the
    stacked call."""
    ex = session.executor
    handles = [session.prepare(q) for q in sqls]
    reqs = [(h.query, h.spec, 100 + i) for i, h in enumerate(handles)]
    d0 = ex.device_dispatches
    outs = session.db.run_pilots_batched(reqs)
    torch.cuda.synchronize()
    dispatches = ex.device_dispatches - d0
    for (q, spec, pseed), out in zip(reqs, outs):
        assert not isinstance(out, Exception), out
        alone = session.db.run_pilot(q, spec, pseed)
        assert out.pilot.n_sampled_blocks == alone.pilot.n_sampled_blocks > 0
        assert np.array_equal(out.pilot.block_sums.view(np.int64),
                              alone.pilot.block_sums.view(np.int64))
        assert np.array_equal(out.pilot.group_present, alone.pilot.group_present)
    return dispatches


def test_stacked_q6_pilots_are_one_batched_launch_on_the_card(cuda):
    """4 constant-varied Q6 pilots: ONE filtered_agg_batched launch, no
    solo launch, each lane bitwise its solo pilot."""
    cat = tpch_catalog(200_000, 32, seed=0, device="cuda")
    s = Session(cat, seed=3, config=SessionConfig(result_cache_size=0))
    sqls = [f"SELECT SUM(l_extendedprice * l_discount) AS rev FROM lineitem "
            f"WHERE l_shipdate BETWEEN {100 + 50 * i} AND {1500 + 30 * i} AND "
            f"l_discount BETWEEN 0.02 AND 0.08 ERROR 8% CONFIDENCE 95%" for i in range(4)]
    handles = [s.prepare(q) for q in sqls]
    reqs = [(h.query, h.spec, 100 + i) for i, h in enumerate(handles)]
    before = (filtered_agg.launches, filtered_agg_batched.launches)
    s.db.run_pilots_batched(reqs)
    torch.cuda.synchronize()
    assert (filtered_agg.launches - before[0],
            filtered_agg_batched.launches - before[1]) == (0, 1)
    try:
        assert _stacked_against_solo(s, sqls) == 1
    finally:
        s.close()


def test_stacked_grouped_pilots_are_one_slab_segment_sum_on_the_card(cuda, monkeypatch):
    """4 constant-varied grouped pilots: ONE segment_sum launch, on the
    slab route, each lane bitwise its solo pilot."""
    from repro_torch.engine import physical
    calls = []

    def recording(vals, seg, num_segments, **kw):
        calls.append(segment_ops.launch_plan(vals.shape[0], vals.shape[1],
                                             num_segments, kw.get("slab_rows"),
                                             kw.get("slab_keys")))
        return segment_sum(vals, seg, num_segments, **kw)

    monkeypatch.setattr(physical, "segment_sum", recording)
    cat = tpch_catalog(200_000, 32, seed=0, device="cuda")
    s = Session(cat, seed=7, config=SessionConfig(result_cache_size=0))
    sqls = [f"SELECT SUM(l_quantity) AS qty, COUNT(*) AS n FROM lineitem "
            f"WHERE l_shipdate < {x} GROUP BY l_returnflag ERROR 15% CONFIDENCE 90%"
            for x in (1800, 2000, 2200, 2400)]
    before = segment_sum.launches
    try:
        assert _stacked_against_solo(s, sqls) == 1
    finally:
        s.close()
    # the stacked call, then the four solo pilots
    assert segment_sum.launches - before == 1 + len(sqls)
    assert [c.route for c in calls] == ["slab"] * (1 + len(sqls))


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


def test_shards_round_robin_over_cards_answer_bitwise(cuda, monkeypatch):
    """With no devices named, shards go round-robin over every visible card
    (it needs two or more), shard i on ``cuda:{i % k}``: each shard's
    tensors and its executor's replicated tables on its own card, and the
    answers and pilot statistics bitwise those of the same shard count
    pinned to one card, fresh and staged; through ``DistExecutor`` and
    through ``Session.register_table(shards=)`` (pinned there by standing
    in for ``dist.shard.default_devices``: the session names no devices)."""
    from repro_torch.dist import DistExecutor, shard
    n_cards = torch.cuda.device_count()
    if n_cards < 2:
        pytest.skip("needs two or more CUDA cards; one card is covered by "
                    "test_shard_counts_answer_bitwise_on_the_card")
    cards = [torch.device("cuda", i) for i in range(n_cards)]
    one_card = [torch.device("cuda", 0)]
    cat = tpch_catalog(200_000, 32, seed=0, device="cuda:0")
    plans, sample, strip = _staged_plans()
    out = {}
    for devices in (None, one_card):
        for rates in ([1e-9], [0.04]):
            ex = DistExecutor(dict(cat), device="cuda:0")
            st = ex.register_sharded("lineitem", cat["lineitem"], 2 * n_cards,
                                     devices=devices)
            ex.register_staged("lineitem", rates, seed=9)
            want_cards = (one_card * (2 * n_cards) if devices else
                          [cards[i % n_cards] for i in range(2 * n_cards)])
            assert [s.table.device for s in st.shards] == want_cards
            for e, card in zip(ex._shard_executors["lineitem"], want_cards):
                assert e.catalog["orders"].device == card
            for name, plan in plans.items():
                p = sample(plan, 0.03)
                out[(devices is None, rates[0], name)] = (
                    ex.execute(p).values,
                    ex.execute_pilot(strip(p), "lineitem", 0.03, 1).block_sums)
    for (spread, rate, name), (v, bs) in out.items():
        want = out[(False, 1e-9, name)]
        assert np.array_equal(_bits64(v), _bits64(want[0])), (spread, rate, name)
        assert np.array_equal(_bits64(bs), _bits64(want[1])), (spread, rate, name)
    answers = {}
    for devices in (None, one_card):
        s = Session(seed=42, config=SessionConfig(result_cache_size=0))
        try:
            s.register_table("orders", cat["orders"])
            with monkeypatch.context() as m:
                if devices:
                    m.setattr(shard, "default_devices", lambda table: one_card)
                s.register_table("lineitem", cat["lineitem"], shards=n_cards + 1,
                                 staged_rates=True)
            placed = [sh.table.device for sh in s.executor._sharded["lineitem"].shards]
            assert placed == (one_card * (n_cards + 1) if devices else
                              [cards[i % n_cards] for i in range(n_cards + 1)])
            answers[devices is None] = [
                s.sql(q + " ERROR 5% CONFIDENCE 95%").answer.values
                for q in ("SELECT SUM(l_extendedprice * l_discount) AS r FROM lineitem "
                          "WHERE l_shipdate BETWEEN 100 AND 1500 AND l_discount "
                          "BETWEEN 0.02 AND 0.08",
                          "SELECT SUM(l_extendedprice) AS s, COUNT(*) AS n FROM lineitem")]
        finally:
            s.close()
    for a, b in zip(answers[True], answers[False]):
        assert np.array_equal(_bits64(a), _bits64(b))


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
# bf16; gemma-7b's d 256 (bf16) and the reduced configs' d 16 (f32), off
# the tiles, with a window and with Sq != Skv
FLASH_CASES = [
    (2, 10, 2, 300, 300, 64, torch.bfloat16, True, 128),
    (1, 4, 4, 200, 200, 64, torch.float32, True, 0),
    (1, 8, 2, 100, 150, 128, torch.float32, False, 0),
    (2, 4, 2, 130, 130, 128, torch.bfloat16, True, 0),
    (1, 5, 1, 257, 257, 64, torch.float32, False, 64),
    (2, 25, 5, 2048, 2048, 64, torch.bfloat16, True, 1024),
    (1, 6, 2, 201, 333, 128, torch.bfloat16, False, 0),
    (2, 4, 4, 300, 300, 256, torch.bfloat16, True, 0),
    (1, 4, 2, 130, 200, 256, torch.bfloat16, False, 0),
    (1, 2, 2, 1000, 1000, 256, torch.bfloat16, True, 100),
    (2, 4, 2, 100, 100, 16, torch.float32, True, 16),
    (1, 4, 4, 70, 130, 16, torch.float32, False, 0),
    (2, 4, 4, 24, 1500, 64, torch.bfloat16, False, 0),
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
# 15 chunks; the reduced configs' (8, 16) in f32
GLA_CASES = [
    (2, 5, 200, 16, 64, torch.bfloat16),
    (1, 3, 130, 64, 64, torch.float32),
    (2, 2, 256, 16, 64, torch.float32),
    (1, 2, 100, 64, 64, torch.bfloat16),
    (2, 25, 2048, 16, 64, torch.bfloat16),
    (1, 3, 1000, 64, 64, torch.float32),
    (2, 4, 200, 8, 16, torch.float32),
    (1, 4, 64, 8, 16, torch.float32),
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


# -- the block draw on the card -------------------------------------------------

# the pilot rate (ErrorSpec.theta_pilot), Q6's final rate at SF10 (~285 of
# 1,875,000 blocks), larger finals up to the plan's cap (max_final_rate), more
DRAW_RATES = (0.0005, 0.00015, 0.003, 0.1, 0.5, 1.0)


@pytest.mark.parametrize("n", [1, 63, 4095, 4096, 4097, 100_003, 1_875_000, 9_375_000])
def test_block_draw_is_the_host_draw_on_the_card(cuda, n):
    """The device draw's ids, count and padded length bitwise
    ``pad_block_ids(draw_block_ids(...))``, one launch a draw; at the
    cells' sizes (SF10's and SF100's blocks) over 210 seeds, the rates
    taken in turn."""
    rng = np.random.default_rng(n)
    seeds = [int(x) for x in rng.integers(0, 2 ** 63, 210 if n >= 1_875_000 else 12)]
    for k, seed in enumerate(seeds):
        rate = DRAW_RATES[k % len(DRAW_RATES)]
        phys, n_real, n_phys = pad_block_ids(draw_block_ids(n, rate, seed), n)
        launches = block_draw.launches
        d = draw_block_ids_device(n, rate, seed, cuda)
        assert block_draw.launches == launches + 1
        assert (d.n_real, d.n_phys) == (n_real, n_phys), (seed, rate)
        assert np.array_equal(d.ids_dev.cpu().numpy(), phys), (seed, rate)


@pytest.mark.parametrize("n", [1, 4097, 100_003, 1_875_000])
def test_block_draw_kernel_is_its_plain_version(cuda, n):
    """The kernel's count and its output up to the padded length against
    the plain version, each call one kernel node and nothing else."""
    for seed in (0, 3_500_000_001):
        state, inc = pcg64_state(seed)
        for rate in DRAW_RATES:
            count, ids = block_draw(n, rate, state, inc, cuda)
            ref_count, ref_ids = block_draw_ref(n, rate, state, inc)
            end = min(bucket_blocks(max(int(ref_count), 1)), n)  # pad_block_ids's n_phys
            assert int(count) == int(ref_count)
            assert torch.equal(ids[:end].cpu(), ref_ids[:end])
    assert captured_node_types(lambda: block_draw(n, 0.003, state, inc, cuda)) == ["kernel"]


def test_block_draw_on_one_scratch_across_sizes_and_the_epoch_wrap(cuda):
    """Draws of shrinking and growing size on one stream's scratch, which
    grows with the table; then across the epoch wrap: the launch of the
    last epoch clears every status and the epochs start again at 1."""
    dev = torch.device("cuda", torch.cuda.current_device())
    stream = torch.cuda.current_stream(dev).cuda_stream

    def check(n, rate, seed):
        phys, n_real, n_phys = pad_block_ids(draw_block_ids(n, rate, seed), n)
        d = draw_block_ids_device(n, rate, seed, dev)
        assert (d.n_real, d.n_phys) == (n_real, n_phys)
        assert np.array_equal(d.ids_dev.cpu().numpy(), phys)

    for k, n in enumerate((1_875_000, 100_000, 9_375_000, 17, 1_875_000)):
        check(n, DRAW_RATES[k], 40 + k)
    scratch = block_draw_ops._scratch[(dev.index, stream)]
    last = 2 ** 32 - 1
    scratch[0] = ((last - 1) << 32) - 2 ** 64           # epoch last - 1, ticket 0 (as int64)
    check(1_875_000, 0.3, 50)
    check(2_000_000, 0.0005, 51)                        # the wrap launch
    torch.cuda.synchronize()
    assert int(scratch[0]) == 1 << 32 and int(scratch[1]) == 0
    assert not scratch[2:].any()
    for n in (9_375_000, 4097):
        check(n, 0.003, 52)
    assert int(scratch[0]) == 3 << 32


def test_a_drawn_sample_outlives_the_next_draw(cuda):
    """What a draw leaves, its padded ids on the card and its real ids on
    the host, are its own: the next draws on the stream leave them as they
    were.  Its SampleInfo waits for nothing until it is settled."""
    first = draw_block_ids_device(1_875_000, 0.00015, 7, cuda)
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        info = first.sample_info(0.00015, 7, 1_875_000, 0)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    assert info.sampled_block_ids is None and info.pending_ids is not None
    kept = first.ids_dev.clone()
    later = [draw_block_ids_device(1_875_000, 0.5, seed, cuda) for seed in range(8, 16)]
    later_infos = [d.sample_info(0.5, 8 + k, 1_875_000, 0) for k, d in enumerate(later)]
    info.settle()
    host = info.sampled_block_ids.copy()
    for k, i in enumerate(later_infos):
        i.settle()
        assert np.array_equal(i.sampled_block_ids, draw_block_ids(1_875_000, 0.5, 8 + k))
    torch.cuda.synchronize()
    assert torch.equal(first.ids_dev, kept) and np.array_equal(info.sampled_block_ids, host)
    assert info.pending_ids is None
    assert np.array_equal(host, draw_block_ids(1_875_000, 0.00015, 7))
    assert first.ids_dev.untyped_storage().nbytes() == 4 * first.n_phys


def test_session_q6_final_ids_are_the_host_draw(cuda):
    """A Q6 through Session.sql on the card: its pilot and final draw on the
    card, and the final's ids are ``draw_block_ids`` at the rate and seed
    the final recorded.  Before its dispatch the final waits on the card
    only for its draw's count; its ids are read after its sums and its
    counts."""
    cat = tpch_catalog(2_000_000, 32, seed=0, device="cuda")
    s = Session(cat, seed=11, config=SessionConfig(result_cache_size=0, tracing=True))
    seen = []
    execute = s.executor.execute

    def spy(plan):
        res = execute(plan)
        seen.extend(i for i in res.sample_infos.values() if i.method == "block")
        return res

    s.executor.execute = spy
    launches = block_draw.launches
    try:
        h = s.sql("SELECT SUM(l_extendedprice * l_discount) AS revenue FROM lineitem "
                  "WHERE l_shipdate BETWEEN 100 AND 1500 AND l_discount BETWEEN 0.02 "
                  "AND 0.08 ERROR 5% CONFIDENCE 95%")
        assert h.status == "done" and h.fallback is None, (h.error, h.fallback)
    finally:
        s.close()
    assert block_draw.launches - launches >= 2  # the pilot's draws and the final's
    info, = seen
    want = draw_block_ids(info.n_total_blocks, info.rate, info.seed)
    assert info.n_sampled_blocks == len(want) > 0
    assert isinstance(info.sampled_block_ids, np.ndarray) and info.pending_ids is None
    assert np.array_equal(info.sampled_block_ids, want)
    final, = h._trace.find("final")
    scan, = [c for c in final.children if c.name == "scan"]
    draw, = [c for c in scan.children if c.name == "draw"]
    dispatch, = [c for c in scan.children if c.name == "dispatch"]
    assert draw.attrs["where"] == "device"
    assert [c.attrs["bytes"] for c in draw.children if c.name == "host_read"] == [4]
    reads = [c for c in scan.children if c.name == "host_read"]
    assert len(reads) == 3 and all(dispatch.t1 <= r.t0 for r in reads)
    assert reads[-1].attrs["bytes"] == 4 * info.n_sampled_blocks


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


# -- the backward kernels: flash_attn_bwd and gla_chunk_bwd -----------------------

def _bf16_within_its_own_rounding(got, plain_bf16, plain_f32, scale, what):
    """bf16: the kernel's distance from the plain f32 backward on the same
    inputs at most 3x the plain bf16 backward's own (both compute in f32 and
    round once to bf16), or 1e-4 of the call's largest gradient where that
    distance is 0 (one query's dq, 0 up to rounding)."""
    own = float((plain_bf16.float() - plain_f32.float()).abs().max())
    err = float((got.float() - plain_f32.float()).abs().max())
    assert err <= max(3 * own, 1e-4 * scale), (what, err, own)


# (B, Hq, Hkv, S, d, causal, window), each in f32 and bf16: one query; GQA
# 1, 2, 5; S 65, 127, 129, 200 off the 64- and 128-row tiles; windows whose
# edge crosses a 128-row tile; non-causal with and without a window; d 64
# and 128.  Then gemma-7b's d 256 in bf16 and the reduced configs' d 16 in
# f32, at the same kinds of shapes (S off the 32- and 64-row tiles)
FLASH_BWD_CASES = [
    (*shape, dtype, *mask)
    for shape, mask in [((1, 2, 2, 1, 64), (True, 0)), ((1, 4, 2, 65, 64), (True, 0)),
                        ((2, 5, 1, 127, 128), (True, 16)), ((1, 5, 5, 200, 64), (False, 0)),
                        ((1, 4, 4, 130, 128), (True, 32)), ((1, 6, 3, 300, 128), (False, 50)),
                        ((1, 4, 2, 129, 128), (True, 0)), ((1, 6, 3, 200, 128), (True, 100)),
                        ((1, 5, 1, 129, 64), (False, 70)), ((1, 2, 1, 200, 64), (True, 150))]
    for dtype in (torch.float32, torch.bfloat16)
] + [
    (*shape, dtype, *mask)
    for dtype, d in ((torch.bfloat16, 256), (torch.float32, 16))
    for shape, mask in [((1, 2, 2, 1, d), (True, 0)), ((1, 4, 2, 65, d), (True, 0)),
                        ((2, 4, 4, 97, d), (False, 0)), ((1, 2, 1, 200, d), (True, 40)),
                        ((1, 4, 2, 130, d), (False, 33))]
] + [
    # bf16 d 256 across its 64-row dQ and dK/dV CTAs: S 64, 127 and 129 on
    # and off their edges, a window whose edge falls inside a 64-row tile,
    # GQA 2 at S 200
    (*shape, torch.bfloat16, *mask)
    for shape, mask in [((1, 2, 2, 64, 256), (True, 0)), ((1, 4, 2, 127, 256), (True, 0)),
                        ((2, 2, 1, 129, 256), (True, 0)), ((1, 2, 2, 129, 256), (False, 0)),
                        ((1, 4, 2, 200, 256), (True, 100)), ((1, 4, 2, 200, 256), (False, 0))]
]
# (B, Hq, Hkv, Sq, Skv, d, causal, window), each in f32 and bf16: non-causal
# with Sq != Skv, as cross-attention runs it: whisper-like MHA over 1500
# encoded frames; llava-like GQA 7 with both lengths off the tiles; then
# bf16 d 256 with GQA 2, both lengths off the 64-row tiles
FLASH_BWD_CROSS_CASES = [
    (*shape, dtype, False, 0)
    for shape in [(1, 4, 4, 40, 1500, 64), (1, 7, 1, 200, 333, 128)]
    for dtype in (torch.float32, torch.bfloat16)
] + [(1, 4, 2, 40, 333, 256, torch.bfloat16, False, 0)]


@pytest.mark.parametrize("case", FLASH_BWD_CASES)
def test_flash_attention_backward_matches_plain_version_on_the_card(cuda, case):
    """The two backward kernels against the plain backward on the same q, k,
    v, o, lse and do: f32 within 1e-4 of the call's largest plain gradient
    (one query's dq is 0 up to rounding, with no scale of its own); bf16 as
    _bf16_within_its_own_rounding.  The forward's lse against the plain
    one's (1e-5); asking for it leaves o bitwise; two backward launches
    bitwise equal, one counted per backward."""
    b, hq, hkv, s, d, dtype, causal, window = case
    _check_flash_backward(cuda, b, hq, hkv, s, s, d, dtype, causal, window)


@pytest.mark.parametrize("case", FLASH_BWD_CROSS_CASES)
def test_flash_attention_backward_with_sq_not_skv_on_the_card(cuda, case):
    """As above, non-causal with Sq != Skv (cross-attention's shape)."""
    _check_flash_backward(cuda, *case)


# a process whose first CUDA work of the backward library is a bf16
# backward on autograd's own thread, which has no CUDA context of its own yet
_FIRST_BACKWARD_ON_AUTOGRADS_THREAD = """
import torch
from repro_torch.kernels.flash_attn import flash_attention
g = torch.Generator(device="cuda").manual_seed(0)
q, k, v, do = (torch.randn((1, 4, 130, 64), generator=g, device="cuda").bfloat16()
               for _ in range(4))
q, k, v = (t.requires_grad_() for t in (q, k, v))
o = flash_attention(q, k, v, causal=True)
grads = torch.autograd.grad(o, (q, k, v), do)
torch.cuda.synchronize()
print(flash_attention.bwd_launches, all(bool(t.isfinite().all()) for t in grads))
"""


def test_flash_attention_backward_first_in_its_process_on_the_card(cuda):
    """The first backward of a process, on autograd's own thread (no CUDA
    context of its own yet), launches once and gives finite gradients; the
    launch reports no error that an earlier runtime call left behind."""
    import os
    import subprocess
    import sys
    src = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "src")
    env = {**os.environ, "PYTHONPATH": src + os.pathsep + os.environ.get("PYTHONPATH", "")}
    done = subprocess.run([sys.executable, "-c", _FIRST_BACKWARD_ON_AUTOGRADS_THREAD],
                          env=env, capture_output=True, text=True, timeout=600)
    assert done.returncode == 0, done.stderr[-2000:]
    assert done.stdout.split() == ["1", "True"], done.stdout


_FIRST_FORWARD_ON_A_NEW_THREAD = """
import threading
import torch
from repro_torch.kernels.flash_attn import flash_attention
g = torch.Generator(device="cuda").manual_seed(0)
q, k, v = (torch.randn((1, 4, 130, 64), generator=g, device="cuda").bfloat16()
           for _ in range(3))
torch.cuda.synchronize()
got = {}

def forward():
    with torch.no_grad():
        got["o"] = flash_attention(q, k, v, causal=True)
    torch.cuda.synchronize()

t = threading.Thread(target=forward)
t.start()
t.join()
with torch.no_grad():
    want = flash_attention(q, k, v, causal=True)
torch.cuda.synchronize()
print(flash_attention.launches, torch.equal(got["o"], want), bool(want.isfinite().all()))
"""


def test_flash_attention_forward_first_on_its_thread_on_the_card(cuda):
    """A bf16 forward as the first CUDA work of a new thread (no current
    context there yet) launches, and gives bitwise the main thread's
    output: the launch's runtime call precedes its tensor-map encoding."""
    import os
    import subprocess
    import sys
    src = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "src")
    env = {**os.environ, "PYTHONPATH": src + os.pathsep + os.environ.get("PYTHONPATH", "")}
    done = subprocess.run([sys.executable, "-c", _FIRST_FORWARD_ON_A_NEW_THREAD],
                          env=env, capture_output=True, text=True, timeout=600)
    assert done.returncode == 0, done.stderr[-2000:]
    assert done.stdout.split() == ["2", "True", "True"], done.stdout


# (B, Hq, Hkv, S, d, dtype): one bf16 width on the tensor cores, one f32
CUSTOM_OP_FLASH = [(2, 4, 2, 130, 64, torch.bfloat16), (2, 4, 2, 70, 16, torch.float32)]


@pytest.mark.parametrize("case", CUSTOM_OP_FLASH, ids=lambda c: str(c[-1])[6:])
def test_flash_custom_ops_launch_the_kernels_as_their_launchers(cuda, case):
    """Through the custom operators (forward, registered backward) the
    card runs exactly what the launchers ``ops._forward`` / ``ops._backward``
    run: bitwise outputs and gradients, one launch each counted."""
    from repro_torch.kernels.flash_attn import flash_attention, ops
    b, hq, hkv, s, d, dtype = case
    rng = np.random.default_rng(d + s)
    q = _normal(rng, (b, hq, s, d), cuda, dtype).requires_grad_()
    k, v = (_normal(rng, (b, hkv, s, d), cuda, dtype).requires_grad_() for _ in range(2))
    do = _normal(rng, (b, hq, s, d), cuda, dtype)
    before = flash_attention.launches, flash_attention.bwd_launches
    o = flash_attention(q, k, v, causal=True, window=0)
    grads = torch.autograd.grad(o, (q, k, v), do)
    torch.cuda.synchronize()
    assert (flash_attention.launches - before[0], flash_attention.bwd_launches - before[1]) == (1, 1)
    scale = 1.0 / d ** 0.5
    qd, kd, vd = q.detach(), k.detach(), v.detach()
    want_o, lse = ops._forward(qd, kd, vd, True, 0, scale, True)
    want = ops._backward(qd, kd, vd, want_o, lse, do, True, 0, scale)
    torch.cuda.synchronize()
    assert torch.equal(o.detach(), want_o)
    assert all(torch.equal(g, w) for g, w in zip(grads, want))


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32], ids=["bfloat16", "float32"])
def test_gla_custom_ops_launch_the_kernels_as_their_launchers(cuda, dtype):
    from repro_torch.kernels.gla_chunk import gla_chunked, ops
    rng = np.random.default_rng(11)
    q, k = (_normal(rng, (2, 3, 130, 16), cuda, dtype).requires_grad_() for _ in range(2))
    v = _normal(rng, (2, 3, 130, 64), cuda, dtype).requires_grad_()
    g = (-torch.from_numpy(rng.uniform(0.01, 2.0, (2, 3, 130, 16)).astype(np.float32))
         ).to(cuda).to(dtype).requires_grad_()
    do = _normal(rng, (2, 3, 130, 64), cuda, dtype)
    before = gla_chunked.launches, gla_chunked.bwd_launches
    o, state = gla_chunked(q, k, v, g)
    grads = torch.autograd.grad(o, (q, k, v, g), do)
    torch.cuda.synchronize()
    assert (gla_chunked.launches - before[0], gla_chunked.bwd_launches - before[1]) == (1, 1)
    det = [t.detach() for t in (q, k, v, g)]
    want_o, want_state, states = ops._forward(*det)
    want = ops._backward(*det, states, want_state, do, None)
    torch.cuda.synchronize()
    assert torch.equal(o.detach(), want_o) and torch.equal(state.detach(), want_state)
    assert all(torch.equal(a, b) for a, b in zip(grads, want))


def test_dtensor_calls_on_a_one_rank_nccl_mesh_are_the_plain_calls(cuda):
    """Flash and GLA on DTensors of a (1, 1) NCCL mesh: the kernels launch on
    the local tensors (counted), and outputs and gradients are bitwise the
    plain tensors' calls."""
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh
    from torch.distributed.tensor import DTensor, Replicate
    from repro_torch.kernels.flash_attn import flash_attention
    from repro_torch.kernels.gla_chunk import gla_chunked
    rng = np.random.default_rng(5)
    q, k, v = (_normal(rng, (2, 4, 130, 64), cuda, torch.bfloat16) for _ in range(3))
    gq, gk = (_normal(rng, (2, 3, 70, 16), cuda, torch.float32) for _ in range(2))
    gv = _normal(rng, (2, 3, 70, 64), cuda, torch.float32)
    gg = -torch.from_numpy(rng.uniform(0.01, 2.0, (2, 3, 70, 16)).astype(np.float32)).to(cuda)
    dist.init_process_group("nccl", store=dist.HashStore(), rank=0, world_size=1)
    try:
        mesh = init_device_mesh("cuda", (1, 1), mesh_dim_names=("data", "model"))
        on = lambda t: DTensor.from_local(t.clone(), mesh, [Replicate(), Replicate()]
                                          ).requires_grad_()
        for fn, args in ((lambda *a: flash_attention(*a, causal=True), (q, k, v)),
                         (lambda *a: gla_chunked(*a)[0], (gq, gk, gv, gg))):
            plain = [t.clone().requires_grad_() for t in args]
            want = fn(*plain)
            want_grads = torch.autograd.grad(want, plain, torch.ones_like(want))
            placed = [on(t) for t in args]
            before = flash_attention.launches + gla_chunked.launches
            got = fn(*placed)
            grads = torch.autograd.grad(got, placed, torch.ones_like(got))
            torch.cuda.synchronize()
            assert flash_attention.launches + gla_chunked.launches - before == 1
            assert isinstance(got, DTensor) and torch.equal(got.to_local(), want)
            assert all(torch.equal(a.to_local(), b) for a, b in zip(grads, want_grads))
    finally:
        dist.destroy_process_group()


def _check_flash_backward(cuda, b, hq, hkv, sq, skv, d, dtype, causal, window):
    from repro_torch.kernels.flash_attn import (flash_attention, flash_attention_bwd_ref,
                                                flash_attention_lse_ref)
    rng = np.random.default_rng(sq + d + hq + (0 if sq == skv else skv))
    q = _normal(rng, (b, hq, sq, d), cuda, dtype).requires_grad_()
    k, v = (_normal(rng, (b, hkv, skv, d), cuda, dtype).requires_grad_() for _ in range(2))
    do = _normal(rng, (b, hq, sq, d), cuda, dtype)
    before = flash_attention.launches, flash_attention.bwd_launches
    o = flash_attention(q, k, v, causal=causal, window=window)
    with torch.no_grad():
        assert torch.equal(o, flash_attention(q, k, v, causal=causal, window=window))
    grads = torch.autograd.grad(o, (q, k, v), do, retain_graph=True)
    again = torch.autograd.grad(o, (q, k, v), do)
    torch.cuda.synchronize()
    assert (flash_attention.launches - before[0], flash_attention.bwd_launches - before[1]) == (2, 2)
    assert all(torch.equal(a, c) for a, c in zip(grads, again))
    q, k, v = q.detach(), k.detach(), v.detach()
    from repro_torch.kernels.flash_attn import ops
    _, lse = ops._forward(q, k, v, causal, window, 1.0 / d ** 0.5, True)
    _, want_lse = flash_attention_lse_ref(q, k, v, causal=causal, window=window)
    torch.testing.assert_close(lse, want_lse, rtol=1e-5, atol=1e-5)
    o = o.detach()
    want = flash_attention_bwd_ref(q, k, v, o, lse, do, causal=causal, window=window)
    if dtype == torch.float32:
        scale = max(float(w.abs().max()) for w in want)
        for g, w in zip(grads, want):
            assert float((g - w).abs().max()) <= 1e-4 * scale
    else:
        want32 = flash_attention_bwd_ref(q.float(), k.float(), v.float(), o.float(), lse,
                                         do.float(), causal=causal, window=window)
        scale = max(float(w.abs().max()) for w in want32)
        for name, g, w, w32 in zip("qkv", grads, want, want32):
            assert g.dtype == dtype
            _bf16_within_its_own_rounding(g, w, w32, scale, f"d{name}")


# (B, H, T, dk, dtype, with a final-state gradient, dv): hymba's (16, 64)
# and rwkv6's (64, 64), T 130 and 200 off the chunk, f32 and bf16; the
# reduced configs' (8, 16) in f32
GLA_BWD_CASES = [
    (1, 3, 130, 16, torch.float32, True, 64),
    (2, 2, 200, 64, torch.bfloat16, False, 64),
    (1, 4, 64, 16, torch.bfloat16, True, 64),
    (1, 2, 100, 64, torch.float32, False, 64),
    (1, 3, 130, 16, torch.bfloat16, True, 64),
    (1, 2, 200, 16, torch.bfloat16, True, 64),
    (1, 3, 130, 64, torch.bfloat16, True, 64),
    (2, 2, 200, 64, torch.float32, True, 64),
    (1, 3, 130, 8, torch.float32, True, 16),
    (2, 4, 200, 8, torch.float32, False, 16),
    (1, 2, 64, 8, torch.float32, True, 16),
]


@pytest.mark.parametrize("case", GLA_BWD_CASES)
def test_gla_chunked_backward_matches_plain_version_on_the_card(cuda, case):
    """The three backward kernels against the plain backward on the same
    inputs, decays below -8 and exactly on both bounds (the jnp.clip half
    gradient there): f32 within 1e-4 of the call's largest plain gradient,
    bf16 as _bf16_within_its_own_rounding; two launches bitwise equal, one
    counted per backward."""
    from repro_torch.kernels.gla_chunk import gla_chunked, gla_chunked_bwd_ref, gla_chunked_fwd_ref
    b, h, t, dk, dtype, with_ds, dv = case
    rng = np.random.default_rng(t + dk)
    q = _normal(rng, (b, h, t, dk), cuda, dtype, 0.5).requires_grad_()
    k = _normal(rng, (b, h, t, dk), cuda, dtype, 0.5).requires_grad_()
    v = _normal(rng, (b, h, t, dv), cuda, dtype).requires_grad_()
    do = _normal(rng, (b, h, t, dv), cuda, dtype)
    g = torch.from_numpy(-rng.uniform(0.0, 0.3, (b, h, t, dk)).astype(np.float32))
    g[..., :3, :] = -9.0
    g[..., 3, :] = -8.0
    g[..., 4, :] = 0.0
    g = g.to(cuda).to(dtype).requires_grad_()
    ds = (torch.from_numpy(rng.standard_normal((b, h, dk, dv)).astype(np.float32)).to(cuda)
          if with_ds else None)
    before = gla_chunked.bwd_launches
    o, s = gla_chunked(q, k, v, g)
    outs, gouts = ([o, s], [do, ds]) if with_ds else ([o], [do])
    grads = torch.autograd.grad(outs, (q, k, v, g), gouts, retain_graph=True)
    again = torch.autograd.grad(outs, (q, k, v, g), gouts)
    torch.cuda.synchronize()
    assert gla_chunked.bwd_launches - before == 2
    assert all(torch.equal(a, c) for a, c in zip(grads, again))
    leaves = [x.detach() for x in (q, k, v, g)]
    _, _, states = gla_chunked_fwd_ref(*leaves)
    want = gla_chunked_bwd_ref(*leaves, states, do, ds)
    if dtype == torch.float32:
        scale = max(float(w.abs().max()) for w in want)
        for gr, w in zip(grads, want):
            assert float((gr - w).abs().max()) <= 1e-4 * scale
    else:
        wide = [x.float() for x in leaves]
        want32 = gla_chunked_bwd_ref(*wide, gla_chunked_fwd_ref(*wide)[2], do.float(), ds)
        scale = max(float(w.abs().max()) for w in want32)
        for name, gr, w, w32 in zip("qkvg", grads, want, want32):
            _bf16_within_its_own_rounding(gr, w, w32, scale, f"d{name}")


@pytest.mark.parametrize("arch", ["gemma-7b", "granite-20b", "granite-moe-1b-a400m",
                                  "hymba-1.5b", "internlm2-1.8b", "llava-next-34b",
                                  "mistral-large-123b", "olmoe-1b-7b", "rwkv6-7b",
                                  "whisper-large-v3"])
def test_reduced_config_runs_on_the_card(cuda, arch):
    """Every family at its ``.reduced()`` widths (head_dim 16, GLA (8, 16),
    f32) through the hand-written kernels: forward and prefill logits within
    1e-4 of the CPU port on the same weights, and one loss's gradients
    within 1e-4 of each leaf's scale (its largest, or 1; f32 on both sides,
    the kernels sum in other orders: test_torch_train.py's gradient
    tolerance); the forward and backward launches counted."""
    from repro_torch.configs import get_config
    from repro_torch.kernels.flash_attn import flash_attention
    from repro_torch.kernels.gla_chunk import gla_chunked
    from repro_torch.models import Model
    from repro_torch.train.step import cross_entropy
    cfg = get_config(arch).reduced()
    cpu = Model(cfg, device="cpu").init(torch.Generator().manual_seed(2))
    gpu = Model(cfg, device=cuda)
    gpu.load_state_dict(cpu.state_dict())
    batch = {k: torch.from_numpy(v) for k, v in spec_batch(cfg, "train", 2, 24, len(arch)).items()}
    n_flash = (cfg.encoder_layers + 2 * cfg.num_layers if cfg.family == "encdec"
               else cfg.num_layers if cfg.has_attention else 0)
    n_gla = cfg.num_layers if cfg.has_ssm else 0
    outs = []
    for model in (cpu, gpu):
        dev = model.embed.device
        b = {k: v.to(dev) for k, v in batch.items()}
        launches = flash_attention.launches, gla_chunked.launches
        with torch.no_grad():
            logits, _ = model(b)
        prompt = {k: v for k, v in b.items() if k != "labels"}
        pl, _ = model.prefill(prompt, cache_len=40)
        torch.cuda.synchronize()
        if dev.type == "cuda":
            assert (flash_attention.launches - launches[0],
                    gla_chunked.launches - launches[1]) == (2 * n_flash, 2 * n_gla)
        model.requires_grad_(True)
        bwd = flash_attention.bwd_launches, gla_chunked.bwd_launches
        lg, aux = model(b)
        loss = cross_entropy(lg, b["labels"], cfg.vocab_size) + 0.01 * aux
        grads = torch.autograd.grad(loss, list(model.parameters()))
        torch.cuda.synchronize()
        if dev.type == "cuda":
            assert (flash_attention.bwd_launches - bwd[0],
                    gla_chunked.bwd_launches - bwd[1]) == (n_flash, n_gla)
        outs.append((logits, pl, [g.cpu() for g in grads]))
    (lc, pc, gc), (lg, pg, gg) = outs
    torch.testing.assert_close(lg.cpu(), lc, rtol=1e-4, atol=1e-4)
    torch.testing.assert_close(pg.cpu(), pc, rtol=1e-4, atol=1e-4)
    for (name, _), a, w in zip(cpu.named_parameters(), gg, gc):
        err = float((a - w).abs().max())
        assert err <= 1e-4 * max(float(w.abs().max()), 1.0), (name, err)


def test_full_width_two_layer_step_on_the_card_matches_the_cpu(cuda):
    """internlm2-1.8b at full width (d 2048, 16 / 8 heads of 128, vocab
    92,544, bf16) with depth cut to 2 layers: two make_train_step steps on
    the card (flash forward and backward kernels) and on the CPU (plain
    versions) from the same weights and batch.  Losses and gradient norms
    within 2^-7 (one bf16 step: both compute attention in f32 but round the
    bf16 matmuls in other orders)."""
    import dataclasses
    from repro_torch.configs import get_config
    from repro_torch.kernels.flash_attn import flash_attention
    from repro_torch.models import Model
    from repro_torch.train.optimizer import AdamWConfig
    from repro_torch.train.step import TrainState, make_train_step
    from repro_torch.train.optimizer import init_opt_state
    cfg = dataclasses.replace(get_config("internlm2-1.8b"), num_layers=2)
    cpu = Model(cfg, device="cpu").init(torch.Generator().manual_seed(0))
    gpu = Model(cfg, device=cuda)
    gpu.load_state_dict(cpu.state_dict())
    toks = np.random.default_rng(0).integers(0, cfg.vocab_size, (1, 129)).astype(np.int32)
    metrics = []
    for model in (cpu, gpu):
        dev = model.embed.device
        model.requires_grad_(True)
        params = dict(model.named_parameters())
        state = TrainState(params, init_opt_state(params), None)
        fn = make_train_step(model, AdamWConfig(lr=1e-4, warmup_steps=0))
        batch = {"tokens": torch.from_numpy(toks[:, :-1]).to(dev),
                 "labels": torch.from_numpy(toks[:, 1:]).to(dev)}
        before = flash_attention.bwd_launches
        seen = []
        for _ in range(2):
            state, m = fn(state, batch)
            seen.append((float(m["loss"]), float(m["grad_norm"])))
        launched = flash_attention.bwd_launches - before
        metrics.append(seen)
    assert launched == 2 * cfg.num_layers
    for (lc, gc), (lg, gg) in zip(*metrics):
        assert np.isfinite([lc, gc, lg, gg]).all()
        np.testing.assert_allclose(lg, lc, rtol=2 ** -7)
        np.testing.assert_allclose(gg, gc, rtol=2 ** -7)
