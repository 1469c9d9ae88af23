"""Launch geometry of the column kernels (``filtered_agg``, ``block_agg``):
how many sampled blocks each warp owns, and the grid.

A launch covers ``batch`` id rows (lanes) of ``n_phys`` sampled blocks each;
a solo call is the launch with one lane.  Each kernel runs CTAs of
``WARPS_PER_CTA`` warps on a ``(grid(n_phys, k), batch)`` grid: within lane
``b`` (``blockIdx.y``), warp ``w`` owns the sampled blocks
``k*w .. k*w + k - 1`` that lie below ``n_phys``, and the kernels are
instantiated for each ``k`` in ``BLOCKS_PER_WARP``.  The output is bitwise
the same for every ``k`` and every batch; only the time differs.  More
blocks per warp keep more loads in flight per warp and cut the number of
CTAs of a large launch; one block per warp spreads a small launch over
every SM.
"""

from __future__ import annotations

WARPS_PER_CTA = 8                 # kWarpsPerCta of csrc/block_reduce.cuh
BLOCKS_PER_WARP = (1, 2, 4)       # the kernels' instantiations
# a k > 1 is taken only while the launch still gives every SM this many CTAs
CTAS_PER_SM = 8


def grid(n_phys: int, k: int) -> int:
    """CTAs of one lane of a launch over ``n_phys`` sampled blocks, ``k`` per
    warp (the grid's x extent; its y extent is the batch)."""
    return -(-n_phys // (k * WARPS_PER_CTA))


def blocks_per_warp(n_phys: int, sms: int, batch: int = 1) -> int:
    """The ``k`` a launch of ``batch`` lanes over ``n_phys`` sampled blocks
    each takes on a card of ``sms`` SMs: the largest one whose whole grid,
    ``batch * grid(n_phys, k)`` CTAs, still holds ``CTAS_PER_SM`` CTAs for
    every SM, and 1 while even that grid would not fill the card."""
    for k in reversed(BLOCKS_PER_WARP):
        if batch * grid(n_phys, k) >= CTAS_PER_SM * sms:
            return k
    return 1
