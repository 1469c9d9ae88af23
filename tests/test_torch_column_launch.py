"""Launch geometry of the solo column kernels (``kernels/column_launch.py``):
which warp and slot own each sampled block, and how many blocks a warp
takes.  Pure Python, run on the CPU; the kernels compute the same mapping
on the card (warp ``w`` of the grid owns blocks ``k*w .. k*w + k - 1`` below
n_phys, ``first_round`` in ``csrc/block_reduce.cuh``)."""

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
