"""Launch geometry of the solo column kernels (``filtered_agg``,
``block_agg``): how many sampled blocks each warp owns, and the grid.

Each kernel runs CTAs of ``WARPS_PER_CTA`` warps; warp ``w`` owns the
sampled blocks ``k*w .. k*w + k - 1`` that lie below ``n_phys``, and the
kernels are instantiated for each ``k`` in ``BLOCKS_PER_WARP``.  The output
is bitwise the same for every ``k``; only the time differs.  More blocks per
warp keep more loads in flight per warp and cut the number of waves of a
large call; one block per warp spreads a small call over every SM.
"""

from __future__ import annotations

WARPS_PER_CTA = 8                 # kWarpsPerCta of csrc/block_reduce.cuh
BLOCKS_PER_WARP = (1, 2, 4)       # the kernels' instantiations
# a k > 1 is taken only while its grid still gives every SM this many CTAs
CTAS_PER_SM = 8


def grid(n_phys: int, k: int) -> int:
    """CTAs of a solo launch over ``n_phys`` sampled blocks, ``k`` per warp."""
    return -(-n_phys // (k * WARPS_PER_CTA))


def blocks_per_warp(n_phys: int, sms: int) -> int:
    """The ``k`` a solo launch over ``n_phys`` sampled blocks takes on a card
    of ``sms`` SMs: the largest one whose grid still holds ``CTAS_PER_SM``
    CTAs for every SM, and 1 while even that grid would not fill the card."""
    for k in reversed(BLOCKS_PER_WARP):
        if grid(n_phys, k) >= CTAS_PER_SM * sms:
            return k
    return 1
