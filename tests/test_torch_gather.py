"""The gather route — GROUP BY, joins, unions, row sampling, OR predicates
and channels the column kernels cannot take — against the reference, on the
CPU.

Both packages see the same bytes: ``tpch_catalog(200_000, block_rows=32,
seed=0)`` (plus, for unions, a second lineitem-shaped table), the port's copy
made through ``repro_torch.convert``.  The reference runs its ``xla`` config,
whose ``xla_gather`` route is the one the port's gather route ports.  Block
ids, row masks, group counts, fallbacks and the choice of plan or fallback
must be equal; rates agree to rtol 1e-6 (the f64 host solve is fed f32 sums
whose last bit may differ), sums and answers to rtol 1e-5 (the port's
``segment_sum`` adds each segment in row order on the CPU, as the
reference's scatter-add does, but its channel expressions may round their
last bit differently).  ``ERROR 15% CONFIDENCE 90%`` lets all three queries
of ``examples/aqp_analytics.py`` reach a sampled final at this size.
"""

import numpy as np
import pytest
import torch

import repro.api as ref_api
import repro.engine.expr as r_expr
import repro.engine.logical as r_L
from repro.engine import Executor as RefExecutor
from repro.engine.datagen import make_lineitem as ref_make_lineitem
from repro.engine.datagen import tpch_catalog as ref_tpch_catalog
import repro_torch.engine.expr as t_expr
import repro_torch.engine.logical as t_L
from repro_torch.api import Session, SessionConfig
from repro_torch.api import avg_ as t_avg, count_ as t_count, sum_ as t_sum
from repro_torch.engine.executor import Executor
from repro_torch.engine.sampling import row_sample
from repro_torch.kernels.segment_sum import segment_sum, segment_sum_ref
from repro_torch.kernels.segment_sum import ops as segment_ops
from repro_torch.kernels.segment_sum.ops import chunk_rows, range_rows
from segment_sum_mirror import mirror_few, mirror_slab, slab_keys
from torch_parity import port_catalog

CHUNK = chunk_rows(1)  # the chunk of every input below 2^24 rows
GUARANTEE = " ERROR 15% CONFIDENCE 90%"
ANALYTICS = {
    "grouped": ("SELECT SUM(l_quantity) AS qty, AVG(l_extendedprice) AS avg_price, "
                "COUNT(*) AS orders FROM lineitem GROUP BY l_returnflag"),
    "join": ("SELECT SUM(l_extendedprice) AS rev FROM lineitem "
             "JOIN orders ON l_orderkey = o_orderkey WHERE o_orderdate < 1200"),
    "q14": ("SELECT SUM(l_extendedprice * l_discount * l_linestatus) / "
            "SUM(l_extendedprice * l_discount) AS promo_share FROM lineitem "
            "WHERE l_shipdate BETWEEN 400 AND 2200"),
}
HERD = [f"SELECT SUM(l_quantity) AS qty, COUNT(*) AS n FROM lineitem "
        f"WHERE l_shipdate < {x} GROUP BY l_returnflag" + GUARANTEE
        for x in (1800, 2000, 2200, 2400)]
SEED = 7


@pytest.fixture(scope="module")
def catalogs():
    ref = ref_tpch_catalog(200_000, 32, seed=0)
    # a second lineitem-shaped table: the other input of a union
    ref["lineitem_b"] = ref_make_lineitem(64_000, 32, num_orders=50_000, seed=5)
    return ref, port_catalog(ref, "cpu")


# ---------------------------------------------------------------------------
# segment_sum: the plain version, and a mirror of the CUDA passes
# ---------------------------------------------------------------------------

def _add_at(vals, seg, num_segments):
    want = np.zeros((vals.shape[0], num_segments))
    ok = (seg >= 0) & (seg < num_segments)
    np.add.at(want.T, seg[ok], vals[:, ok].T.astype(np.float64))
    return want


def assert_f32_sums(got, vals, seg, num_segments):
    """``got`` holds f32 sums of each segment's values, in whatever order:
    within the recursive-summation bound of an f64 sum, |error| <= n u
    sum|x| for n values and the f32 unit roundoff u = 2^-24 (the values are
    signed, so a relative tolerance on a cancelling sum would mean nothing)."""
    want = _add_at(vals, seg, num_segments)
    count = _add_at(np.ones((1, vals.shape[1]), np.float32), seg, num_segments)
    bound = count * 2.0 ** -24 * _add_at(np.abs(vals), seg, num_segments)
    assert np.all(np.abs(np.asarray(got, np.float64) - want) <= bound)


SHAPES = [  # (channels, rows, segments, key draw)
    (3, 10_000, 50, "random"),
    (2, 3 * CHUNK * 5 + 17, 3, "random"),       # runs of many chunks
    (2, 32_768, 10_000_000, "random"),          # S >> R: a join pilot's pairs
    (1, 5_000, 7, "random"),
    (9, 20_000, 100, "random"),                 # more channels than a pass keeps
    (5, 100_000, 1, "random"),                  # one run: an ungrouped query
    (2, 4 * CHUNK, 40, "sorted"),               # runs cut at the tile edges
    (2, 0, 5, "random"),                        # no rows
]


def _keys(rng, rows, segments, kind):
    k = rng.integers(0, segments, rows)
    return np.sort(k) if kind == "sorted" else k


@pytest.mark.parametrize("shape", SHAPES, ids=lambda s: f"{s[0]}x{s[1]}->{s[2]}")
def test_segment_sum_plain_version_matches_numpy(shape):
    c, r, s, kind = shape
    rng = np.random.default_rng(r + s)
    vals = rng.standard_normal((c, r)).astype(np.float32)
    seg = _keys(rng, r, s, kind)
    calls = segment_sum.calls
    got = segment_sum(torch.from_numpy(vals), torch.from_numpy(seg), s)
    assert segment_sum.calls == calls + 1 and got.dtype == torch.float32
    assert tuple(got.shape) == (c, s)
    assert_f32_sums(got.numpy(), vals, seg, s)
    empty = np.ones(s, bool)
    empty[seg] = False
    assert not got.numpy()[:, empty].any()            # empty segments exactly 0


def _mirror(vals, seg, num_segments, chunk=None):
    """The CUDA passes of csrc/segment_sum.cu in numpy, f32 arithmetic in
    the kernel's order: keys, a stable sort, chunk starts per tile of
    ``chunk`` positions (the wrapper's choice by default), the prefix of the
    tile counts, each chunk's lane-strided sum and butterfly (the output
    itself where the chunk is a whole run), then each longer run's chunk
    partials in chunk order.  Returns (out, number of chunks, the scratch
    capacity the wrapper allots)."""
    c_n, rows = vals.shape
    chunk = chunk or chunk_rows(rows)
    keys = np.where((seg >= 0) & (seg < num_segments), seg, -1).astype(np.int32)
    order = np.argsort(keys, kind="stable")
    skeys = keys[order]
    pos = np.arange(rows)
    starts = (pos % chunk == 0) | np.concatenate([[True], skeys[1:] != skeys[:-1]])
    tiles = -(-rows // chunk)
    counts = np.add.reduceat(starts.astype(np.int64), np.arange(0, rows, chunk))
    first = np.concatenate([[0], np.cumsum(counts)])
    chunk_start = np.nonzero(starts)[0]
    assert first[-1] == len(chunk_start) and len(counts) == tiles

    def warp_sum(lanes):                      # the xor butterfly of 32 lanes
        v = lanes.copy()
        o = 16
        while o:
            v = (v + v[np.arange(32) ^ o]).astype(np.float32)
            o >>= 1
        return v[0]

    def strided(xs):                          # lane l adds items l, l+32, ...
        lanes = np.zeros(32, np.float32)
        for j, x in enumerate(xs):
            lanes[j % 32] = np.float32(lanes[j % 32] + x)
        return warp_sum(lanes)

    ends = np.concatenate([chunk_start[1:], [rows]])
    part = np.array([[strided(vals[c, order[a:b]]) for a, b in zip(chunk_start, ends)]
                     for c in range(c_n)], np.float32).reshape(c_n, -1)
    out = np.zeros((c_n, num_segments), np.float32)
    ckeys = skeys[chunk_start]
    for i, key in enumerate(ckeys):
        if key < 0 or (i and ckeys[i - 1] == key):
            continue
        end = i
        while end < len(ckeys) and ckeys[end] == key:
            end += 1
        for c in range(c_n):
            out[c, key] = part[c, i] if end == i + 1 else strided(part[c, i:end])
    cap = min(rows, tiles + min(rows, num_segments))
    return out, len(chunk_start), cap


@pytest.mark.parametrize("shape", [(2, 3 * CHUNK + 100, 3, "random", None),
                                   (3, 9_000, 2_000, "random", None),
                                   (2, 2 * CHUNK + 5, 5, "sorted", None),
                                   (1, 3_000, 1, "random", None),
                                   (2, 3 * 4096 + 100, 3, "random", 4096)],
                         ids=lambda s: f"{s[0]}x{s[1]}->{s[2]}/{s[4] or CHUNK}")
def test_segment_sum_kernel_passes_mirrored(shape):
    """The kernel's algorithm, mirrored on the CPU: chunks never span two
    runs nor exceed the chunk size (1,024 below 2^24 rows, 4,096 above;
    the last case takes the large one at a small size), their count fits
    the scratch the wrapper allots, and the fixed-order sums equal the
    plain version's."""
    c, r, s, kind, chunk = shape
    rng = np.random.default_rng(s)
    vals = rng.standard_normal((c, r)).astype(np.float32)
    seg = _keys(rng, r, s, kind)
    out, n_chunks, cap = _mirror(vals, seg, s, chunk)
    assert n_chunks <= cap
    assert_f32_sums(out, vals, seg, s)
    plain = segment_sum_ref(torch.from_numpy(vals), torch.from_numpy(seg), s).numpy()
    assert_f32_sums(plain, vals, seg, s)


def test_segment_sum_mirror_drops_out_of_range_keys():
    vals = np.ones((2, 1000), np.float32)
    seg = np.concatenate([np.arange(990) % 10, [-5, 10, 11, 99, -1, 3, 3, 3, 3, 3]])
    out, _, _ = _mirror(vals, seg, 10)
    np.testing.assert_array_equal(out, _add_at(vals, seg, 10))


def test_segment_sum_plain_version_drops_out_of_range_keys():
    """The plain version drops a row whose key lies outside [0, S), as the
    kernel does: the wrapper computes one function on either device."""
    rng = np.random.default_rng(4)
    vals = rng.standard_normal((2, 1000)).astype(np.float32)
    seg = np.concatenate([np.arange(990) % 10, [-5, 10, 11, 99, -1, 3, 3, 3, 3, 3]])
    got = segment_sum(torch.from_numpy(vals), torch.from_numpy(seg), 10)
    keep = (seg >= 0) & (seg < 10)
    want = segment_sum_ref(torch.from_numpy(vals[:, keep]),
                           torch.from_numpy(seg[keep]), 10)
    assert torch.equal(got, want)
    assert_f32_sums(got.numpy(), vals, seg, 10)


def test_segment_sum_wrapper_checks_its_inputs():
    vals = torch.zeros(2, 8)
    seg = torch.zeros(8, dtype=torch.int64)
    with pytest.raises(ValueError, match="float32"):
        segment_sum(vals.double(), seg, 3)
    with pytest.raises(ValueError, match="int64"):
        segment_sum(vals, seg.int(), 3)
    with pytest.raises(ValueError, match="int64"):
        segment_sum(vals, seg[:5], 3)
    with pytest.raises(ValueError, match="num_segments"):
        segment_sum(vals, seg, 2 ** 31)
    with pytest.raises(ValueError, match="cuda or cpu"):
        segment_sum(vals.to("meta"), seg.to("meta"), 3)


# ---------------------------------------------------------------------------
# segment_sum's sort-free routes: the slab and few kernels' orders, mirrored
# ---------------------------------------------------------------------------

SLAB_CASES = [  # (channels, slab_rows, W, slabs, ragged tail rows, extra empty slabs)
    (3, 32, 1, 40, 17, 3),       # the pilot block sums: one key a slab
    (5, 32, 3, 40, 9, 2),        # the Q1 pilot: 3 groups a block
    (2, 32, 1_000, 12, 5, 0),    # a join pilot's pair sums: W > 32, zero-filled output
    (4, 100, 7, 9, 61, 1),       # 100-row blocks: several steps a slab, a ragged last step
    (9, 256, 2, 5, 0, 0),        # more channels than a pass keeps
]


@pytest.mark.parametrize("case", SLAB_CASES, ids=lambda c: f"{c[0]}ch-br{c[1]}-W{c[2]}")
def test_segment_sum_slab_route_mirrored(case):
    """The slab route's order, mirrored: held to the plain version (which
    checks the slab claim) within the f32 summation bound of both, and to an
    f64 sum; keys past the slabs with rows stay 0, scratch rows are
    dropped."""
    c, br, w, slabs, tail, empty = case
    rng = np.random.default_rng(br * w + c)
    rows = slabs * br + tail
    nseg = (-(-rows // br) + empty) * w
    seg = slab_keys(rng, rows, br, w, nseg, rows - br // 2)
    vals = rng.standard_normal((c, rows)).astype(np.float32)
    plan = segment_ops.launch_plan(c, rows, nseg, br, w)
    assert plan.route == "slab" and plan.variant == ("lane" if w <= 32 else "wide")
    out = mirror_slab(vals, seg, nseg, br, w)
    assert_f32_sums(out, vals, seg, nseg)
    plain = segment_sum(torch.from_numpy(vals), torch.from_numpy(seg), nseg,
                        slab_rows=br, slab_keys=w).numpy()
    assert_f32_sums(plain, vals, seg, nseg)
    count = _add_at(np.ones((1, rows), np.float32), seg, nseg)
    bound = 2 * count * 2.0 ** -24 * _add_at(np.abs(vals), seg, nseg)
    assert np.all(np.abs(out.astype(np.float64) - plain) <= bound)
    assert not out[:, count[0] == 0].any()


FEW_CASES = [  # (channels, rows, segments)
    (2, 3 * 256 + 77, 1),         # an ungrouped final: ranges of 256 rows, a ragged tail
    (5, 3 * 256 + 200, 3),        # the Q1 final's shape
    (3, 2 * 256 + 31, 1_025),     # a pilot without a slab claim: S * C 3,075
    (2, 274 * 256 - 3, 3),        # more ranges than the range pass has threads
    (9, 700, 4),                  # more channels than a lane's registers keep at once
    (1, 5 * 256, 300),            # S > 4: warp slots, ranges with no row of most keys
]


@pytest.mark.parametrize("case", FEW_CASES, ids=lambda c: f"{c[0]}x{c[1]}->{c[2]}")
def test_segment_sum_few_route_mirrored(case):
    """The few route's order, mirrored, across range boundaries and ragged
    tails: held to the plain version within the f32 summation bound of both,
    and to an f64 sum; empty segments exactly 0; out-of-range keys
    dropped."""
    c, rows, nseg = case
    rng = np.random.default_rng(rows + nseg)
    vals = rng.standard_normal((c, rows)).astype(np.float32)
    seg = rng.integers(0, nseg + 2, rows) - 1         # -1 and S: dropped
    plan = segment_ops.launch_plan(c, rows, nseg)
    assert plan.route == "few"
    assert plan.variant == ("lane" if nseg <= 4 else "warp")
    ranges = -(-rows // range_rows(rows))
    assert plan.grids == (-(-ranges // 8), c * nseg)
    out, part = mirror_few(vals, seg, nseg)
    assert_f32_sums(out, vals, seg, nseg)
    plain = segment_sum(torch.from_numpy(vals), torch.from_numpy(seg), nseg).numpy()
    count = _add_at(np.ones((1, rows), np.float32), seg, nseg)
    bound = 2 * count * 2.0 ** -24 * _add_at(np.abs(vals), seg, nseg)
    assert np.all(np.abs(out.astype(np.float64) - plain) <= bound)
    assert not out[:, count[0] == 0].any()
    # each range partial is its own rows' sum
    rr = range_rows(rows)
    for g in (0, part.shape[1] - 1):
        lo = g * rr
        sub = _add_at(vals[:, lo:lo + rr], seg[lo:lo + rr], nseg)
        np.testing.assert_allclose(part[:, g].reshape(c, nseg), sub, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("rows", [1, 255, 256, 1 << 20, (1 << 20) + 1, 60_000_000])
def test_few_route_ranges_depend_on_the_row_count_alone(rows):
    """Ranges are a power of two of at least 256 rows, at most 4,096 of them,
    and the fewest such: one function of R."""
    rr = range_rows(rows)
    assert rr >= 256 and rr & (rr - 1) == 0
    assert -(-rows // rr) <= 4096
    assert rr == 256 or -(-rows // (rr // 2)) > 4096


ROUTE_CASES = [  # (C, R, S, slab_rows, slab_keys) -> (route, variant)
    ((2, 32_768, 1_025, 32, 1), ("slab", "lane")),          # join pilot block sums
    ((3, 32_768, 1_025, 32, 1), ("slab", "lane")),          # Q14 pilot block sums
    ((5, 4_194_304, 393_216, 32, 3), ("slab", "lane")),     # Q1 pilot
    ((2, 32_768, 480_000_000, 32, 468_750), ("slab", "wide")),  # join pilot pair sums
    ((2, 8_192, 1, None, None), ("few", "lane")),           # join final
    ((5, 65_536, 3, None, None), ("few", "lane")),          # Q1 final
    ((5, 60_000_000, 3, None, None), ("few", "lane")),      # exact Q1
    ((2, 60_000_000, 1, None, None), ("few", "lane")),      # exact join
    ((3, 65_536, 1_025, None, None), ("few", "warp")),      # a pilot with no claim
    ((4, 10_000, 1_024, None, None), ("few", "warp")),      # S * C at the budget
    ((4, 10_000, 1_025, None, None), ("sorted", "sorted")),  # one past it
    ((3, 1_000_000, 100_000, None, None), ("sorted", "sorted")),
]


@pytest.mark.parametrize("case", ROUTE_CASES, ids=lambda c: "x".join(map(str, c[0][:3])))
def test_segment_sum_route_is_a_function_of_the_call_alone(case):
    """The route and its launches follow from (C, R, S, slab claim) alone:
    the planning functions take nothing else (no device, no SM count), and
    the recorded pilots, finals and exact scans never reach the sort."""
    import inspect
    (c, r, s, br, w), want = case
    assert list(inspect.signature(segment_ops.launch_plan).parameters) == \
        ["channels", "rows", "num_segments", "slab_rows", "slab_keys", "force"]
    plan = segment_ops.launch_plan(c, r, s, br, w)
    assert (plan.route, plan.variant) == want
    assert plan == segment_ops.launch_plan(c, r, s, br, w)
    assert len(plan.grids) == {"slab": 1, "few": 2, "sorted": 6}[plan.route]


def test_segment_sum_plain_version_raises_on_a_false_slab_claim():
    """The plain version checks the slab claim: a key in range but in
    another slab than its row raises; keys out of range are never held to
    it."""
    rng = np.random.default_rng(9)
    rows, br, w = 320, 32, 3
    seg = slab_keys(rng, rows, br, w, 10 * w, rows)
    vals = torch.from_numpy(rng.standard_normal((2, rows)).astype(np.float32))
    ok = segment_sum(vals, torch.from_numpy(seg), 10 * w, slab_rows=br, slab_keys=w)
    assert torch.equal(ok, segment_sum(vals, torch.from_numpy(seg), 10 * w))
    seg[40] = 5 * w                                   # row 40 lies in slab 1
    with pytest.raises(ValueError, match="slab claim broken: row 40"):
        segment_sum(vals, torch.from_numpy(seg), 10 * w, slab_rows=br, slab_keys=w)
    seg[40] = 10 * w + 1                              # out of range: dropped, no claim
    segment_sum(vals, torch.from_numpy(seg), 10 * w, slab_rows=br, slab_keys=w)
    with pytest.raises(ValueError, match="both slab_rows and slab_keys"):
        segment_sum(vals, torch.from_numpy(seg), 10 * w, slab_rows=br)
    with pytest.raises(ValueError, match="must be >= 1"):
        segment_sum(vals, torch.from_numpy(seg), 10 * w, slab_rows=0, slab_keys=w)


# ---------------------------------------------------------------------------
# Executor.execute, route by route
# ---------------------------------------------------------------------------

def _plan(L, E, what):
    block = lambda rate, seed: L.SampleClause("block", rate, seed)
    price, disc, qty = E.Col("l_extendedprice"), E.Col("l_discount"), E.Col("l_quantity")
    s_c = (L.AggSpec("sum", price, "s"), L.AggSpec("count", None, "n"))
    if what == "group_by":
        return L.Aggregate(L.Scan("lineitem", block(0.1, 1)),
                           (L.AggSpec("sum", qty, "qty"), L.AggSpec("avg", price, "p"),
                            L.AggSpec("count", None, "n")), "l_returnflag", 3)
    if what == "group_by_exact":
        return L.Aggregate(L.Filter(L.Scan("lineitem"), E.Cmp("<", E.Col("l_shipdate"),
                                                              E.Const(2000.0))),
                           s_c, "l_linestatus", 2)
    if what == "join":
        return L.Aggregate(L.Filter(
            L.Join(L.Scan("lineitem", block(0.05, 2)), L.Scan("orders"),
                   "l_orderkey", "o_orderkey"),
            E.Cmp("<", E.Col("o_orderdate"), E.Const(1200.0))), s_c)
    if what == "join_both_sampled":
        return L.Aggregate(L.Join(L.Scan("lineitem", block(0.2, 3)),
                                  L.Scan("orders", block(0.5, 4)),
                                  "l_orderkey", "o_orderkey"),
                           (L.AggSpec("sum", E.Col("o_totalprice"), "t"),
                            L.AggSpec("count", None, "n")))
    if what == "join_grouped_exact":
        return L.Aggregate(L.Join(L.Scan("lineitem"), L.Scan("orders"),
                                  "l_orderkey", "o_orderkey"),
                           s_c, "o_orderpriority", 5)
    if what == "union":
        return L.Aggregate(L.Union((L.Scan("lineitem", block(0.1, 5)),
                                    L.Scan("lineitem_b"))), s_c)
    if what == "row_sample":
        return L.Aggregate(L.Scan("lineitem", L.SampleClause("row", 0.1, 6)),
                           s_c + (L.AggSpec("avg", qty, "q"),))
    if what == "or_filter":
        return L.Aggregate(L.Filter(L.Scan("lineitem", block(0.1, 7)),
                                    E.Or(E.Cmp("<", qty, E.Const(5.0)),
                                         E.Cmp(">", qty, E.Const(40.0)))), s_c)
    if what == "equality":
        return L.Aggregate(L.Filter(L.Scan("lineitem", block(0.1, 8)),
                                    E.Cmp("==", E.Col("l_returnflag"), E.Const(1.0))), s_c)
    if what == "sum_ab_filterless":
        return L.Aggregate(L.Scan("lineitem", block(0.1, 9)),
                           (L.AggSpec("sum", E.BinOp("*", price, disc), "rev"),))
    if what == "triple_product":
        return L.Aggregate(L.Filter(L.Scan("lineitem", block(0.1, 10)),
                                    E.Between(E.Col("l_shipdate"), 400.0, 2200.0)),
                           (L.AggSpec("sum", E.BinOp("*", E.BinOp("*", price, disc),
                                                     E.Col("l_linestatus")), "promo"),
                            L.AggSpec("sum", E.BinOp("*", price, disc), "rev")))
    raise ValueError(what)


ROUTES = ["group_by", "group_by_exact", "join", "join_both_sampled",
          "join_grouped_exact", "union", "row_sample", "or_filter", "equality",
          "sum_ab_filterless", "triple_product"]


@pytest.fixture(scope="module")
def executors(catalogs):
    ref, port = catalogs
    return RefExecutor(ref, kernel_mode="xla"), Executor(port, device="cpu")


def assert_results_match(r, t):
    """One query's port result against the reference's."""
    assert t.agg_names == r.agg_names
    assert t.sample_infos.keys() == r.sample_infos.keys()
    for name, ri in r.sample_infos.items():
        ti = t.sample_infos[name]
        assert (ti.method, ti.rate, ti.seed) == (ri.method, ri.rate, ri.seed)
        assert (ti.n_sampled_blocks, ti.n_sampled_rows, ti.n_total_rows) == \
            (ri.n_sampled_blocks, ri.n_sampled_rows, ri.n_total_rows)
        if ri.sampled_block_ids is not None:
            np.testing.assert_array_equal(ti.sampled_block_ids, ri.sampled_block_ids)
    assert t.scanned_bytes == r.scanned_bytes
    np.testing.assert_array_equal(t.group_counts, r.group_counts)
    np.testing.assert_array_equal(t.group_present, r.group_present)
    np.testing.assert_allclose(t.raw_sums, r.raw_sums, rtol=1e-5)
    np.testing.assert_allclose(t.values, r.values, rtol=1e-5)


@pytest.mark.parametrize("what", ROUTES)
def test_execute_takes_the_gather_route_and_matches_reference(executors, what):
    rex, tex = executors
    r = rex.execute(_plan(r_L, r_expr, what))
    calls = segment_sum.calls
    t = tex.execute(_plan(t_L, t_expr, what))
    assert segment_sum.calls == calls + 1          # one reduction per query
    plan = _plan(t_L, t_expr, what)
    runtimes, _ = tex._scan_runtimes(plan)
    assert tex.physical.compile_query(plan, runtimes).route == "gather"
    assert_results_match(r, t)


def test_row_sample_matches_reference(catalogs):
    from repro.engine.sampling import row_sample as ref_row_sample
    ref, port = catalogs
    rt, ri = ref_row_sample(ref["lineitem"], 0.1, 11)
    tt, ti = row_sample(port["lineitem"], 0.1, 11)
    np.testing.assert_array_equal(tt.valid.numpy(), np.asarray(rt.valid))
    assert (ti.method, ti.n_sampled_rows, ti.n_total_rows, ti.scanned_bytes) == \
        (ri.method, ri.n_sampled_rows, ri.n_total_rows, ri.scanned_bytes)


def test_row_scan_runtime_matches_reference(catalogs, executors):
    """The executor's row-sampled scan draws the reference's mask and
    counts its kept rows as the reference does (on the table's device)."""
    ref, _ = catalogs
    rex, tex = executors
    plan = t_L.Aggregate(t_L.Scan("lineitem", t_L.SampleClause("row", 0.1, 11)),
                         (t_L.AggSpec("count", None, "n"),))
    rplan = r_L.Aggregate(r_L.Scan("lineitem", r_L.SampleClause("row", 0.1, 11)),
                          (r_L.AggSpec("count", None, "n"),))
    runtimes, infos = tex._scan_runtimes(plan)
    _, rinfos = rex._scan_runtimes(rplan)
    from repro.engine.sampling import row_sample as ref_row_sample
    keep = runtimes["lineitem"].keep_mask
    assert isinstance(keep, torch.Tensor) and keep.device.type == "cpu"
    rt, _ = ref_row_sample(ref["lineitem"], 0.1, 11)
    np.testing.assert_array_equal(
        keep.numpy() & np.asarray(ref["lineitem"].valid), np.asarray(rt.valid))
    t, r = infos["lineitem"], rinfos["lineitem"]
    assert (t.method, t.n_sampled_rows, t.n_total_rows, t.scanned_bytes) == \
        (r.method, r.n_sampled_rows, r.n_total_rows, r.scanned_bytes)


def test_grouped_exact_sums_stay_within_f64(catalogs, executors):
    """Exact grouped sums are f32 row-order sums, as the reference's: held
    to an f64 numpy sum of the same data at the f32 rounding of 200k rows."""
    ref, _ = catalogs
    _, tex = executors
    t = tex.execute(_plan(t_L, t_expr, "group_by_exact"))
    li = ref["lineitem"]
    ship = np.asarray(li.columns["l_shipdate"])
    keep = np.asarray(li.valid) & (ship < 2000)
    status = np.asarray(li.columns["l_linestatus"])
    price = np.asarray(li.columns["l_extendedprice"]).astype(np.float64)
    for g in (0, 1):
        m = keep & (status == g)
        assert t.group_counts[g] == m.sum()
        np.testing.assert_allclose(t.raw_sums[0, g], price[m].sum(), rtol=1e-5)


# ---------------------------------------------------------------------------
# execute_pilot: per-block sums, group presence, join-pair sums
# ---------------------------------------------------------------------------

PILOTS = {  # plan, pair tables
    "grouped": ("group_by", ()),
    "join_pairs": ("join", ("orders",)),
    "join_no_pairs": ("join", ()),
    "union": ("union", ()),
    "triple_product": ("triple_product", ()),
}


@pytest.mark.parametrize("name", sorted(PILOTS))
def test_execute_pilot_matches_reference(executors, name):
    rex, tex = executors
    what, pairs = PILOTS[name]
    strip = lambda L, p: L.strip_samples(p)
    r = rex.execute_pilot(strip(r_L, _plan(r_L, r_expr, what)), "lineitem", 0.05,
                          123, pair_tables=pairs)
    t = tex.execute_pilot(strip(t_L, _plan(t_L, t_expr, what)), "lineitem", 0.05,
                          123, pair_tables=pairs)
    assert (t.n_sampled_blocks, t.n_total_blocks, t.block_rows, t.agg_names) == \
        (r.n_sampled_blocks, r.n_total_blocks, r.block_rows, r.agg_names)
    assert t.scanned_bytes == r.scanned_bytes
    assert t.block_sums.shape == r.block_sums.shape
    np.testing.assert_allclose(t.block_sums, r.block_sums, rtol=1e-5)
    np.testing.assert_array_equal(t.group_present, r.group_present)
    assert t.pair_sums.keys() == r.pair_sums.keys()
    assert t.right_total_blocks == r.right_total_blocks
    for k, v in r.pair_sums.items():
        assert t.pair_sums[k].dtype == np.float64 and t.pair_sums[k].shape == v.shape
        np.testing.assert_allclose(t.pair_sums[k], v, rtol=1e-5)
    if pairs and what == "join":
        assert t.pair_sums["orders"].any()


def test_pilot_routes(executors):
    """A pilot with one group and no pair statistics over Filter*(Scan) of
    kernel-computable channels takes a kernel; every other shape the
    gather route."""
    from repro_torch.engine.physical import ScanRuntime
    from repro_torch.engine.sampling import draw_block_ids, pad_block_ids
    _, tex = executors
    phys = tex.physical
    nb = tex.table_blocks("lineitem")
    ids, n_real, n_phys = pad_block_ids(draw_block_ids(nb, 0.01, 3), nb)
    runtime = ScanRuntime("block", n_real, n_phys, ids)
    route = lambda plan, pair=None: phys.compile_pilot(
        plan, "lineitem", runtime, pair).route
    q6 = t_L.Aggregate(t_L.Filter(t_L.Scan("lineitem"), t_expr.Between(
        t_expr.Col("l_shipdate"), 100.0, 1500.0)),
        (t_L.AggSpec("sum", t_expr.Col("l_extendedprice"), "s"),))
    assert route(q6) != "gather"
    for what in ("group_by", "union", "triple_product", "or_filter", "join"):
        plan = t_L.strip_samples(_plan(t_L, t_expr, what))
        assert route(plan) == "gather", what
    join = t_L.strip_samples(_plan(t_L, t_expr, "join"))
    assert route(join, "orders") == "gather"


def _spy_segment_sum(monkeypatch):
    """Record the keywords of every segment_sum call of the physical layer."""
    from repro_torch.engine import physical
    calls = []
    real = physical.segment_sum

    def spy(vals, seg, num_segments, **kw):
        calls.append((tuple(vals.shape), num_segments, kw))
        return real(vals, seg, num_segments, **kw)

    monkeypatch.setattr(physical, "segment_sum", spy)
    return calls


@pytest.mark.parametrize("name", ["grouped", "join_pairs", "union"])
def test_gather_pilots_claim_their_slabs(executors, monkeypatch, name):
    """A pilot whose pilot table's rows come first and are scanned once
    states the slab claim: block_rows rows a slab, max_groups keys for the
    block sums and the right table's block count for the pair sums; the
    scratch rows' keys lie past n_phys * W.  The plain version checks the
    claim, so the pilot's equality with the reference holds it too."""
    _, tex = executors
    what, pairs = PILOTS[name]
    calls = _spy_segment_sum(monkeypatch)
    plan = t_L.strip_samples(_plan(t_L, t_expr, what))
    res = tex.execute_pilot(plan, "lineitem", 0.05, 123, pair_tables=pairs)
    widths = [plan.max_groups] + ([tex.table_blocks("orders")] if pairs else [])
    assert [kw for _, _, kw in calls] == [dict(slab_rows=32, slab_keys=w) for w in widths]
    n_phys = calls[0][1] // widths[0]              # the padded pilot-block bucket
    assert n_phys >= res.n_sampled_blocks > 0
    assert [nseg for _, nseg, _ in calls] == [n_phys * w for w in widths]
    rows = calls[0][0][1]
    assert rows == n_phys * 32 if name != "union" else rows > n_phys * 32


def test_union_scanning_the_pilot_table_twice_makes_no_claim(catalogs, executors,
                                                              monkeypatch):
    """A union that scans the pilot table twice puts pilot blocks' rows in
    two places, so its pilot states no slab claim and takes the few route
    (S * C within the budget) on the card; its block sums still equal the
    reference's (every pilot block counted twice, as there)."""
    rex, tex = executors
    s_c = lambda L, E: (L.AggSpec("sum", E.Col("l_extendedprice"), "s"),
                        L.AggSpec("count", None, "n"))
    plan = lambda L, E: L.Aggregate(L.Union((L.Scan("lineitem"), L.Scan("lineitem"))),
                                    s_c(L, E))
    calls = _spy_segment_sum(monkeypatch)
    r = rex.execute_pilot(plan(r_L, r_expr), "lineitem", 0.05, 123)
    t = tex.execute_pilot(plan(t_L, t_expr), "lineitem", 0.05, 123)
    assert [kw for _, _, kw in calls] == [{}]
    (c, rows), nseg, _ = calls[0]
    assert segment_ops.launch_plan(c, rows, nseg).route == "few"
    assert t.n_sampled_blocks == r.n_sampled_blocks
    np.testing.assert_allclose(t.block_sums, r.block_sums, rtol=1e-5)
    np.testing.assert_array_equal(t.group_present, r.group_present)
    once = tex.execute_pilot(t_L.Aggregate(t_L.Scan("lineitem"), s_c(t_L, t_expr)),
                             "lineitem", 0.05, 123)
    np.testing.assert_allclose(t.block_sums, 2 * once.block_sums, rtol=1e-6)


# ---------------------------------------------------------------------------
# Session.sql: the three analytics queries end to end
# ---------------------------------------------------------------------------

def _spy(session):
    seen = {"pilots": [], "final_ids": []}
    ex = session.executor
    execute, execute_pilot = ex.execute, ex.execute_pilot

    def spy_pilot(plan, table, theta_p, seed, pair_tables=()):
        seen["pilots"].append((table, theta_p, seed, tuple(pair_tables)))
        return execute_pilot(plan, table, theta_p, seed, pair_tables=pair_tables)

    def spy_execute(plan):
        res = execute(plan)
        seen["final_ids"].append({t: i.sampled_block_ids
                                  for t, i in res.sample_infos.items()})
        return res

    ex.execute_pilot, ex.execute = spy_pilot, spy_execute
    return seen


def assert_handles_match(h, rh, seen=None, r_seen=None):
    assert (h.status, h.error) == ("done", None) and rh.status == "done"
    assert h.seed == rh.seed
    assert h.fallback == rh.fallback
    rep, rrep = h.report, rh.report
    assert (rep.pilot_table, rep.n_pilot_blocks) == (rrep.pilot_table, rrep.n_pilot_blocks)
    assert rep.theta_pilot == rrep.theta_pilot
    assert rep.pilot_scanned_bytes == rrep.pilot_scanned_bytes
    assert (rep.plan is None) == (rrep.plan is None)
    if rep.plan is not None:
        assert rep.plan.rates.keys() == rrep.plan.rates.keys()
        for t, r in rep.plan.rates.items():
            assert r == pytest.approx(rrep.plan.rates[t], rel=1e-6)
        assert rep.final_scanned_bytes == rrep.final_scanned_bytes
    if seen is not None:
        assert seen["pilots"] == r_seen["pilots"]
        assert len(seen["final_ids"]) == len(r_seen["final_ids"])
        for a, b in zip(seen["final_ids"], r_seen["final_ids"]):
            assert a.keys() == b.keys()
            for t in a:
                assert np.array_equal(a[t], b[t])
    assert h.answer.names == rh.answer.names
    np.testing.assert_array_equal(h.answer.group_present, rh.answer.group_present)
    np.testing.assert_allclose(h.answer.values, rh.answer.values, rtol=1e-5)


@pytest.fixture(scope="module")
def analytics_runs(catalogs):
    ref, port = catalogs
    out = {}
    for name, sql in ANALYTICS.items():
        for kind, text in (("approx", sql + GUARANTEE), ("exact", sql)):
            ts = Session(port, seed=SEED, device="cpu")
            rs = ref_api.Session(ref, seed=SEED,
                                 config=ref_api.SessionConfig(kernel_mode="xla"))
            seen, r_seen = _spy(ts), _spy(rs)
            calls = segment_sum.calls
            h = ts.sql(text)
            out[name, kind] = (h, rs.sql(text), seen, r_seen,
                               segment_sum.calls - calls)
    return out


@pytest.mark.parametrize("kind", ["approx", "exact"])
@pytest.mark.parametrize("name", sorted(ANALYTICS))
def test_analytics_sql_matches_reference(analytics_runs, name, kind):
    h, rh, seen, r_seen, _ = analytics_runs[name, kind]
    assert_handles_match(h, rh, seen, r_seen)


@pytest.mark.parametrize("name", sorted(ANALYTICS))
def test_analytics_reach_a_sampled_final_through_segment_sum(analytics_runs, name):
    """At ERROR 15% each query really sampled (the reference's plans of
    lineitem at 0.0490, lineitem at 0.00532 with orders whole, lineitem at
    0.0828), and both its pilot and its final reduced through segment_sum."""
    h, _, seen, _, calls = analytics_runs[name, "approx"]
    assert h.fallback is None and h.report.plan is not None
    assert h.report.plan.rates["lineitem"] < 0.1
    assert calls == 2 + (name == "join")   # a join pilot adds its pair sums
    if name == "join":
        assert seen["pilots"][0][3] == ("orders",)


def test_guarantee_holds_on_the_analytics_queries(analytics_runs):
    for name in ANALYTICS:
        a = analytics_runs[name, "approx"][0].answer
        e = analytics_runs[name, "exact"][0].answer
        present = e.group_present
        assert np.all(np.abs(a.values - e.values)[:, present]
                      <= 0.15 * np.abs(e.values)[:, present]), name


# ---------------------------------------------------------------------------
# The fluent builder, unions and row samples through the session
# ---------------------------------------------------------------------------

def test_builder_lowers_to_the_sql_query_and_matches_reference(catalogs):
    ref, port = catalogs
    from repro.api import avg_ as r_avg, count_ as r_count, sum_ as r_sum
    ts = Session(port, seed=SEED, device="cpu")
    rs = ref_api.Session(ref, seed=SEED, config=ref_api.SessionConfig(kernel_mode="xla"))

    def build(session, E, sum_, avg_, count_):
        return (session.table("lineitem")
                .where(E.Col("l_shipdate") < 2400)
                .group_by("l_returnflag")
                .agg(sum_(E.Col("l_quantity")).as_("qty"),
                     avg_(E.Col("l_extendedprice")).as_("avg_price"),
                     count_().as_("orders"))
                .error(0.15, 0.90))

    tb = build(ts, t_expr, t_sum, t_avg, t_count)
    q, spec = tb.build()
    sql = ts.prepare("SELECT SUM(l_quantity) AS qty, AVG(l_extendedprice) AS "
                     "avg_price, COUNT(*) AS orders FROM lineitem WHERE "
                     "l_shipdate < 2400 GROUP BY l_returnflag" + GUARANTEE)
    assert (q, spec) == (sql.query, sql.spec)
    h = tb.run()
    rh = build(rs, r_expr, r_sum, r_avg, r_count).run()
    assert_handles_match(h, rh)
    assert h.report.plan is not None
    with pytest.raises(KeyError):
        ts.table("nope")


def _union_query(mod_taqa, mod_spec, L, E, sample=None):
    child = L.Filter(L.Union((L.Scan("lineitem", sample), L.Scan("lineitem_b"))),
                     E.Cmp("<", E.Col("l_shipdate"), E.Const(2000.0)))
    return mod_taqa.Query(child, (mod_spec.CompositeAgg("rev", "sum", E.Col("l_extendedprice")),
                                  mod_spec.CompositeAgg("n", "count", None)))


@pytest.mark.parametrize("kind", ["approx", "row_sampled_exact"])
def test_union_and_row_sample_through_the_session(catalogs, kind):
    import repro.core.spec as r_spec
    import repro.core.taqa as r_taqa
    import repro_torch.core.spec as t_spec
    import repro_torch.core.taqa as t_taqa
    ref, port = catalogs
    ts = Session(port, seed=SEED, device="cpu")
    rs = ref_api.Session(ref, seed=SEED, config=ref_api.SessionConfig(kernel_mode="xla"))
    if kind == "approx":
        tq = _union_query(t_taqa, t_spec, t_L, t_expr)
        rq = _union_query(r_taqa, r_spec, r_L, r_expr)
        h = ts.execute(tq, t_spec.ErrorSpec(error=0.15, confidence=0.90))
        rh = rs.execute(rq, r_spec.ErrorSpec(error=0.15, confidence=0.90))
    else:  # exact execution of a plan that row-samples its table itself
        tq = _union_query(t_taqa, t_spec, t_L, t_expr, t_L.SampleClause("row", 0.2, 3))
        rq = _union_query(r_taqa, r_spec, r_L, r_expr, r_L.SampleClause("row", 0.2, 3))
        h, rh = ts.db.exact(tq), rs.db.exact(rq)
        np.testing.assert_allclose(h.values, rh.values, rtol=1e-5)
        return
    assert_handles_match(h, rh)


# ---------------------------------------------------------------------------
# The drain: solo pilots and gather_batched finals
# ---------------------------------------------------------------------------

def _drain(session, herd=HERD):
    hs = [session.submit(q) for q in herd]
    session.drain()
    return hs


JOIN_HERD = [f"SELECT SUM(l_extendedprice) AS rev FROM lineitem JOIN orders "
             f"ON l_orderkey = o_orderkey WHERE o_orderdate < {x}" + GUARANTEE
             for x in (1000, 1200, 1400)]


@pytest.mark.parametrize("kind", ["grouped", "join"])
def test_grouped_herd_drain_matches_reference_and_solo(catalogs, kind):
    """A drain herd against the reference's drain and against solo runs:
    the grouped members' pilots stack into one call, a join's each run solo
    with pair statistics, and the finals batch on gather_batched (a join's
    with ``orders`` scanned whole)."""
    herd = HERD if kind == "grouped" else JOIN_HERD
    ref, port = catalogs
    ts = Session(port, seed=SEED, device="cpu",
                 config=SessionConfig(async_workers=0, result_cache_size=0))
    ex = ts.executor
    pilots, stacks, routes = [], [], []
    execute_pilot, compile_batched = ex.execute_pilot, \
        ex.physical.compile_batched_query
    execute_stacked = ex.execute_pilots_batched

    def spy_pilot(plan, table, theta_p, seed, pair_tables=()):
        pilots.append(tuple(pair_tables))
        return execute_pilot(plan, table, theta_p, seed, pair_tables=pair_tables)

    def spy_stacked(plans, *a):
        stacks.append(len(plans))
        return execute_stacked(plans, *a)

    def spy_compile(*a, **kw):
        c = compile_batched(*a, **kw)
        routes.append(c.route)
        return c

    ex.execute_pilot = spy_pilot
    ex.execute_pilots_batched = spy_stacked
    ex.physical.compile_batched_query = spy_compile
    hs = _drain(ts, herd)
    rs = ref_api.Session(ref, seed=SEED, config=ref_api.SessionConfig(
        kernel_mode="xla", async_workers=0, result_cache_size=0))
    rhs = _drain(rs, herd)
    # the grouped pilots as one stacked call; a join's solo, each with its
    # pair table
    if kind == "grouped":
        assert (pilots, stacks) == ([], [len(herd)])
    else:
        assert (pilots, stacks) == ([("orders",)] * len(herd), [])
    assert routes and set(routes) == {"gather_batched"}
    solo = Session(port, seed=SEED, device="cpu",
                   config=SessionConfig(result_cache_size=0))
    for h, rh in zip(hs, rhs):
        assert_handles_match(h, rh)
        assert h.report.plan is not None
        alone = solo.sql(h.sql)
        np.testing.assert_array_equal(h.answer.values, alone.answer.values)
    assert ts.scheduler.last_drain.pilots_run == len(herd)
    ts.close(), rs.close(), solo.close()


def test_a_failing_pilot_fails_only_its_own_member(catalogs):
    """``run_pilots_batched`` captures a member's pilot failure on that
    member alone: its siblings (stacked without it) finish, bitwise their
    solo runs."""
    _, port = catalogs
    ts = Session(port, seed=SEED, device="cpu",
                 config=SessionConfig(async_workers=0, result_cache_size=0))
    prelude = ts.db._pilot_prelude

    def broken(q, spec):
        if "2000" in repr(q):
            raise RuntimeError("pilot refused")
        return prelude(q, spec)

    ts.db._pilot_prelude = broken
    hs = _drain(ts)
    solo = Session(port, seed=SEED, device="cpu",
                   config=SessionConfig(result_cache_size=0))
    failed = [h for h in hs if h.status != "done"]
    assert [h.sql for h in failed] == [HERD[1]]
    assert "pilot refused" in str(failed[0].error)
    for h in hs:
        if h.status == "done":
            np.testing.assert_array_equal(h.answer.values,
                                          solo.sql(h.sql).answer.values)
    ts.close(), solo.close()


@pytest.mark.parametrize("shape", ["grouped", "grouped_join"])
def test_batched_pilot_members_are_bitwise_solo_pilots(catalogs, shape):
    """Each outcome of ``run_pilots_batched`` is bitwise the member's own
    ``run_pilot``, a grouped join's too: same draw, same block sums."""
    _, port = catalogs
    ts = Session(port, seed=SEED, device="cpu",
                 config=SessionConfig(result_cache_size=0))
    if shape == "grouped":
        sqls = HERD[:2]
    else:
        sqls = [f"SELECT SUM(l_quantity) AS q FROM lineitem JOIN orders ON "
                f"l_orderkey = o_orderkey WHERE l_shipdate < {x} "
                f"GROUP BY o_orderpriority" + GUARANTEE for x in (1500, 2500)]
    handles = [ts.prepare(sql) for sql in sqls]
    reqs = [(h.query, h.spec, 100 + i) for i, h in enumerate(handles)]
    outs = ts.db.run_pilots_batched(reqs)
    for (q, spec, pseed), out in zip(reqs, outs):
        alone = ts.db.run_pilot(q, spec, pseed)
        assert out.fallback == alone.fallback and out.pilot is not None
        np.testing.assert_array_equal(out.pilot.block_sums, alone.pilot.block_sums)
        np.testing.assert_array_equal(out.pilot.group_present,
                                      alone.pilot.group_present)
        assert out.pilot.n_sampled_blocks == alone.pilot.n_sampled_blocks > 0
    ts.close()
