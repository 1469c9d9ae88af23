"""Launch geometry of the column kernels (``kernels/column_launch.py``):
which CTA, warp and slot own each (lane, sampled block), and how many
blocks a warp takes.  Pure Python, run on the CPU; the kernels compute the
same mapping on the card (``blockIdx.y`` is the lane; within it warp ``w``
owns blocks ``k*w .. k*w + k - 1`` below n_phys, ``first_round`` in
``csrc/block_reduce.cuh``)."""

import numpy as np
import pytest

from repro_torch.kernels import column_launch as cl


def owner_counts(n_phys: int, k: int) -> np.ndarray:
    """How many (warp, slot) pairs of the grid claim each block index, for
    every index a live slot names (so a slot past n_phys shows up as an
    index >= n_phys)."""
    warps = np.arange(cl.grid(n_phys, k) * cl.WARPS_PER_CTA)
    first = warps * k
    warps = warps[first < n_phys]          # a warp past n_phys exits whole
    blocks = (warps * k)[:, None] + np.arange(k)[None, :]
    live = blocks[blocks < n_phys]         # the kernels' live[j]
    return np.bincount(live, minlength=n_phys)


@pytest.mark.parametrize("k", cl.BLOCKS_PER_WARP)
def test_every_block_has_exactly_one_warp_and_slot(k):
    for n_phys in range(1, 4097):
        counts = owner_counts(n_phys, k)
        assert counts.shape == (n_phys,), (n_phys, k)
        assert np.all(counts == 1), (n_phys, k)


@pytest.mark.parametrize("k", cl.BLOCKS_PER_WARP)
def test_the_grid_has_no_empty_cta(k):
    for n_phys in range(1, 4097):
        g = cl.grid(n_phys, k)
        per_cta = k * cl.WARPS_PER_CTA
        assert (g - 1) * per_cta < n_phys <= g * per_cta, (n_phys, k)


@pytest.mark.parametrize("sms", [132, 114, 1])
def test_blocks_per_warp_is_one_until_the_card_is_full(sms):
    previous = 1
    for n_phys in list(range(1, 5000)) + [2 ** e for e in range(13, 21)]:
        k = cl.blocks_per_warp(n_phys, sms)
        assert k in cl.BLOCKS_PER_WARP
        if cl.grid(n_phys, 1) < sms:       # one block per warp does not fill it
            assert k == 1, (n_phys, sms)
        if k > 1:                          # every SM still gets a full share
            assert cl.grid(n_phys, k) >= cl.CTAS_PER_SM * sms, (n_phys, sms)
        if k < max(cl.BLOCKS_PER_WARP):    # the next k would starve some SM
            nxt = cl.BLOCKS_PER_WARP[cl.BLOCKS_PER_WARP.index(k) + 1]
            assert cl.grid(n_phys, nxt) < cl.CTAS_PER_SM * sms, (n_phys, sms)
        assert k >= previous, (n_phys, sms)  # more blocks never take a smaller k
        previous = k


def test_main_path_sizes_take_the_measured_choice():
    """On the H100's 132 SMs: the SQL path's pilots and finals (512 and
    1,024 sampled blocks) keep one block per warp; a 65,536-block final
    takes four (PERF.md, the k sweep of chip_smoke.py)."""
    assert cl.blocks_per_warp(512, 132) == 1
    assert cl.blocks_per_warp(1_024, 132) == 1
    assert cl.blocks_per_warp(65_536, 132) == 4


def lane_block_owners(n_phys: int, k: int, batch: int) -> np.ndarray:
    """How many (CTA, warp, slot) triples of a (grid(n_phys, k), batch)
    launch claim each (lane, block) pair, flattened as lane * n_phys +
    block; a live slot past n_phys would show as an index past its lane."""
    gx = cl.grid(n_phys, k)
    cta_x, cta_y, warp, slot = np.meshgrid(np.arange(gx), np.arange(batch),
                                           np.arange(cl.WARPS_PER_CTA),
                                           np.arange(k), indexing="ij")
    first = (cta_x * cl.WARPS_PER_CTA + warp) * k
    block = first + slot
    live = (first < n_phys) & (block < n_phys)  # the warp exits; live[j]
    owned = cta_y[live].astype(np.int64) * n_phys + block[live]
    return np.bincount(owned, minlength=batch * n_phys)


@pytest.mark.parametrize("k", cl.BLOCKS_PER_WARP)
@pytest.mark.parametrize("batch", [1, 2, 3, 8])
def test_every_lane_and_block_has_exactly_one_cta_warp_and_slot(batch, k):
    for n_phys in range(1, 1025):
        counts = lane_block_owners(n_phys, k, batch)
        assert counts.shape == (batch * n_phys,), (n_phys, k, batch)
        assert np.all(counts == 1), (n_phys, k, batch)


def solo_rule(n_phys: int, sms: int) -> int:
    """The solo launch's choice as it stood before batched launches took k:
    the largest k whose grid gives every SM CTAS_PER_SM CTAs, else 1."""
    for k in reversed(cl.BLOCKS_PER_WARP):
        if cl.grid(n_phys, k) >= cl.CTAS_PER_SM * sms:
            return k
    return 1


@pytest.mark.parametrize("sms", [132, 114, 1])
def test_a_one_lane_launch_keeps_the_solo_choice(sms):
    for n_phys in list(range(1, 5001)) + [2 ** e for e in range(13, 21)]:
        want = solo_rule(n_phys, sms)
        assert cl.blocks_per_warp(n_phys, sms) == want, (n_phys, sms)
        assert cl.blocks_per_warp(n_phys, sms, batch=1) == want, (n_phys, sms)


@pytest.mark.parametrize("batch", [2, 3, 8, 64])
def test_blocks_per_warp_counts_every_cta_of_the_launch(batch):
    """k > 1 only while the whole (grid, batch) launch still gives each of
    132 SMs a full share, and the next k would not; more lanes never take a
    smaller k."""
    sms = 132
    for n_phys in list(range(1, 3000, 7)) + [2 ** e for e in range(12, 18)]:
        k = cl.blocks_per_warp(n_phys, sms, batch)
        assert k >= cl.blocks_per_warp(n_phys, sms, 1), (n_phys, batch)
        if k > 1:
            assert batch * cl.grid(n_phys, k) >= cl.CTAS_PER_SM * sms, (n_phys, batch)
        if k < max(cl.BLOCKS_PER_WARP):
            nxt = cl.BLOCKS_PER_WARP[cl.BLOCKS_PER_WARP.index(k) + 1]
            assert batch * cl.grid(n_phys, nxt) < cl.CTAS_PER_SM * sms, (n_phys, batch)


@pytest.mark.parametrize("batch, n_phys, k, ctas", [
    (8, 512, 1, 512),          # the drain's Q6 bucket
    (4, 64, 1, 32),            # the drain's SUM/COUNT bucket
    (8, 65_536, 4, 16_384),    # a large batched final: (2,048, 8) CTAs
])
def test_main_path_batched_shapes_take_the_chosen_k(batch, n_phys, k, ctas):
    """On the H100's 132 SMs (PERF.md, the batched k sweep of chip_smoke.py)."""
    assert cl.blocks_per_warp(n_phys, 132, batch) == k
    assert batch * cl.grid(n_phys, k) == ctas
