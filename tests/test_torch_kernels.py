"""The port's filtered_agg / block_agg wrappers (CPU route: the plain PyTorch
versions) against the reference's Pallas kernels in interpret mode.

Counts must match exactly; sums within the tolerances ``test_kernels.py``
already allows between the reference's kernels and its own oracles (rtol
1e-5 for block_agg, 1e-4 for filtered_agg): both sides sum a block's rows in
f32, in different orders.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.block_agg import block_agg as ref_block_agg
from repro.kernels.filtered_agg import filtered_agg as ref_filtered_agg
from repro_torch.kernels.block_agg import block_agg
from repro_torch.kernels.filtered_agg import filtered_agg

N_BLOCKS = 24
EMPTY_BLOCK = 3  # every row invalid
Q6_BOUNDS = (100.0, 1500.0, 0.02, 0.08, 24.0)


def _lineitem_like(block_rows: int, seed: int):
    """Q6-shaped columns: f32 price, discount k/100 (rows exactly on the
    0.02 / 0.08 bounds), int32 shipdate, f32 quantity; bool valid with one
    all-invalid block."""
    rng = np.random.default_rng(seed)
    n = N_BLOCKS * block_rows
    price = rng.uniform(900.0, 1100.0, n).astype(np.float32)
    discount = rng.integers(0, 11, n).astype(np.float32) / 100.0
    shipdate = rng.integers(0, 2526, n).astype(np.int32)
    quantity = rng.integers(1, 51, n).astype(np.float32)
    valid = rng.random(n) < 0.9
    valid[EMPTY_BLOCK * block_rows:(EMPTY_BLOCK + 1) * block_rows] = False
    return price, discount, shipdate, quantity, valid


def _ids(seed: int) -> np.ndarray:
    """Repeated ids, the empty block, and the zero padding of pad_block_ids."""
    rng = np.random.default_rng(seed)
    real = np.concatenate([rng.integers(0, N_BLOCKS, 9), [EMPTY_BLOCK, 5, 5]])
    return np.concatenate([real, np.zeros(4)]).astype(np.int32)


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


@pytest.mark.parametrize("block_rows", [8, 32, 100])
@pytest.mark.parametrize("channel", ["product", "sum", "count"])
def test_filtered_agg_matches_reference(block_rows, channel):
    price, discount, shipdate, quantity, valid = _lineitem_like(block_rows, 1)
    ids = _ids(2)
    # the shapes the physical layer lowers: SUM(a*b), SUM(col) (y absent in
    # the port, a ones column in the reference), COUNT-only (x = y = f1)
    if channel == "product":
        x, y, ref_y = price, discount, discount
    elif channel == "sum":
        x, y, ref_y = price, None, np.ones_like(price)
    else:
        x, y, ref_y = shipdate, shipdate, shipdate
    cols = (shipdate, discount, quantity)
    ref = np.asarray(ref_filtered_agg(
        jnp.asarray(x), jnp.asarray(ref_y), *(jnp.asarray(c) for c in cols),
        jnp.asarray(valid), block_rows, ids, Q6_BOUNDS, interpret=True))
    out = filtered_agg(_t(x), None if y is None else _t(y),
                       *(_t(c) for c in cols), _t(valid), block_rows, _t(ids),
                       torch.tensor(Q6_BOUNDS, dtype=torch.float32))
    assert out.shape == (len(ids), 3) and out.dtype == torch.float32
    out = out.numpy()
    np.testing.assert_array_equal(out[:, 0], ref[:, 0])
    np.testing.assert_allclose(out[:, 1:], ref[:, 1:], rtol=1e-4)
    # the all-invalid block keeps nothing
    assert (out[ids == EMPTY_BLOCK] == 0).all()


def test_filtered_agg_rows_on_the_bounds_are_kept():
    """l_discount = k/100 in f32 sits exactly on 0.02 / 0.08: compared in f32
    against f32 bounds, those rows pass, as in the reference."""
    br = 32
    price, discount, shipdate, quantity, valid = _lineitem_like(br, 3)
    valid[:] = True
    ids = np.arange(N_BLOCKS, dtype=np.int32)
    edge = (discount == np.float32(0.02)) | (discount == np.float32(0.08))
    assert edge.sum() > 0
    bounds = (0.02, 0.08, -3e38, 3e38, 3e38)  # the discount slots only
    out = filtered_agg(_t(price), None, _t(discount), _t(discount),
                       _t(discount), _t(valid), br, _t(ids),
                       torch.tensor(bounds, dtype=torch.float32)).numpy()
    d32 = discount.reshape(N_BLOCKS, br)
    want = ((d32 >= np.float32(0.02)) & (d32 <= np.float32(0.08))).sum(axis=1)
    np.testing.assert_array_equal(out[:, 0], want)
    ref = np.asarray(ref_filtered_agg(
        *(jnp.asarray(c) for c in (price, np.ones_like(price), discount,
                                   discount, discount, valid)),
        br, ids, bounds, interpret=True))
    np.testing.assert_array_equal(out[:, 0], ref[:, 0])


@pytest.mark.parametrize("block_rows", [8, 32, 100])
@pytest.mark.parametrize("values", ["f32", "int32", "count"])
def test_block_agg_matches_reference(block_rows, values):
    price, _, shipdate, _, valid = _lineitem_like(block_rows, 4)
    ids = _ids(5)
    col = {"f32": price, "int32": shipdate, "count": valid}[values]
    ref = np.asarray(ref_block_agg(jnp.asarray(col), jnp.asarray(valid),
                                   block_rows, ids, interpret=True))
    out = block_agg(_t(col), _t(valid), block_rows, _t(ids))
    assert out.shape == (len(ids), 5) and out.dtype == torch.float32
    out = out.numpy()
    np.testing.assert_array_equal(out[:, 0], ref[:, 0])
    np.testing.assert_allclose(out[:, 1:3], ref[:, 1:3], rtol=1e-5)
    # min / max do not depend on order: equal, NaN sentinel included
    np.testing.assert_array_equal(out[:, 3:], ref[:, 3:])
    empty = ids == EMPTY_BLOCK
    assert (out[empty, :3] == 0).all() and np.isnan(out[empty, 3:]).all()


def test_cpu_tensors_take_the_plain_version():
    """The tensors' device alone routes a call: a CPU call counts as a call,
    never as a kernel launch."""
    price, discount, shipdate, quantity, valid = _lineitem_like(32, 6)
    ids = _t(_ids(7))
    calls, launches = filtered_agg.calls, filtered_agg.launches
    filtered_agg(_t(price), _t(discount), _t(shipdate), _t(discount),
                 _t(quantity), _t(valid), 32, ids,
                 torch.tensor(Q6_BOUNDS, dtype=torch.float32))
    assert (filtered_agg.calls, filtered_agg.launches) == (calls + 1, launches)
    calls, launches = block_agg.calls, block_agg.launches
    block_agg(_t(price), _t(valid), 32, ids)
    assert (block_agg.calls, block_agg.launches) == (calls + 1, launches)


@pytest.mark.parametrize("bad", ["float_valid", "int64_ids", "ragged", "bounds"])
def test_wrappers_reject_what_the_kernels_do_not_take(bad):
    price, discount, shipdate, quantity, valid = _lineitem_like(32, 8)
    ids = _t(_ids(9))
    bounds = torch.tensor(Q6_BOUNDS, dtype=torch.float32)
    v = _t(valid)
    if bad == "float_valid":
        v = v.float()
    elif bad == "int64_ids":
        ids = ids.long()
    elif bad == "ragged":
        price = price[:-1]
    elif bad == "bounds":
        bounds = bounds[:4]
    with pytest.raises((ValueError, TypeError)):
        filtered_agg(_t(price), None, _t(shipdate), _t(discount),
                     _t(quantity), v, 32, ids, bounds)
    if bad != "bounds":
        with pytest.raises((ValueError, TypeError)):
            block_agg(_t(price), v, 32, ids)


@pytest.mark.parametrize("ids_shape, bounds_shape, match", [
    ((200,), (5,), "launches on cuda"),          # a solo launch, CPU tensors
    ((3, 200), (3, 5), "launches on cuda"),      # a batched launch, CPU tensors
    ((0, 200), (0, 5), "batch 0"),               # no lane
    ((3, 200), (5,), "bounds"),                  # batched ids, solo bounds
    ((2, 3, 200), (2, 3, 5), "ids"),             # neither solo nor batched
])
def test_launch_takes_solo_or_batched_ids_and_runs_on_cuda_only(ids_shape,
                                                                 bounds_shape,
                                                                 match):
    """``ops.launch`` (the one kernel at a named blocks-per-warp) takes
    (n_phys,) ids with (5,) bounds or (B, n_phys) ids with (B, 5) bounds,
    and launches only: a CPU tensor raises rather than take the plain
    version."""
    from repro_torch.kernels.block_agg import ops as block_ops
    from repro_torch.kernels.filtered_agg import ops as filtered_ops
    price, discount, shipdate, quantity, valid = _lineitem_like(32, 10)
    ids = torch.zeros(ids_shape, dtype=torch.int32)
    bounds = torch.zeros(bounds_shape, dtype=torch.float32)
    with pytest.raises(ValueError, match=match):
        filtered_ops.launch(_t(price), _t(discount), _t(shipdate), _t(discount),
                            _t(quantity), _t(valid), 32, ids, bounds, 1)
    if match != "bounds":
        with pytest.raises(ValueError, match=match):
            block_ops.launch(_t(price), _t(valid), 32, ids, 1)
