"""The taqa_solve kernels' parallel orders, mirrored in numpy
(``taqa_solve_mirror.py``), against their sequential plain versions.

* The rate solve's speculative-tree bisection, for every k in {1, 4, 8}
  and the kernel's own k, gives bit for bit the plain version's theta and
  flags over 200 seeded random pilots: n_solve 1, 2, 8 and 64; n_real 0 to
  2 and larger; infeasible plans, theta at max_rate, L_mu <= 0, no groups.
  Under a non-monotone feasibility predicate the walk still ends where the
  sequential loop ends.
* The single-pass compaction, replayed tile by tile in seeded random orders
  that keep only the kernel's ordering edges, equals the plain version for
  every n and theta tried, on a scratch that lives from call to call: stale
  statuses of earlier calls never count, and the launch of the last epoch
  clears every status before the epochs start again.

The card tests (``test_torch_cuda.py``) hold the kernels to these mirrors.
"""

import functools

import numpy as np
import pytest
import torch

from repro_torch.kernels.taqa_solve import taqa_draw_compact_ref, taqa_solve_rate_ref
from taqa_solve_mirror import (LAST_EPOCH, DrawScratch, draw_mirror, feasibility,
                               kernel_levels, sequential_walk, solve_mirror,
                               speculative_walk)

N_SOLVE = (1, 2, 8, 64)
PILOTS = 50               # per n_solve: 200 in all
KS = (1, 4, 8, None)      # None: the kernel's own k


def random_pilot(rng, n_solve):
    """numpy inputs of one taqa_solve_rate call, drawn to reach every
    branch: sums with negative means (L_mu <= 0), errors from hopeless to
    lax (infeasible plans, theta at max_rate or near min_rate), cost lines
    above and below the exact cost, no groups."""
    n_phys = int(rng.choice([1, 2, 3, 64, 300, 1024, 2048]))
    n_real = int(min(n_phys, rng.choice([0, 1, 2, n_phys, rng.integers(0, n_phys + 1)])))
    n_ch = n_solve + int(rng.integers(0, 3))
    bs = np.zeros((n_phys, n_ch), np.float32)
    for c in range(n_ch):
        kind = rng.integers(4)
        if kind == 0:
            col = rng.gamma(2.0, 5_000.0, n_real)
        elif kind == 1:
            col = rng.normal(rng.choice([-50.0, 1.2e6]), rng.choice([1.0, 1e5]), n_real)
        elif kind == 2:
            col = np.full(n_real, 32.0)
        else:
            col = rng.normal(0.0, 1.0, n_real) * (rng.random(n_real) < 0.1)
        bs[:n_real, c] = col
    channels = rng.permutation(n_ch)[:n_solve].astype(np.int32)
    solve = np.stack([rng.uniform(1.0, 3.0, n_solve),
                      rng.choice([0.0, 0.9 * max(n_real - 1, 0), rng.uniform(0, 1e4)],
                                 n_solve),
                      rng.uniform(1.5, 3.0, n_solve), rng.uniform(1.5, 3.0, n_solve),
                      rng.choice([1e-5, 0.01, 0.05, 0.5, 50.0], n_solve)],
                     axis=1).astype(np.float32)
    N = float(rng.choice([1_000.0, 1_875_000.0, 6.0e7]))
    exact = float(rng.uniform(1e8, 2e9))
    scal = np.array([N, rng.choice([1.0, 0.5, 0.05]), rng.choice([1e-9, 1e-6, 1e-3]),
                     rng.uniform(0.0, 2e9), rng.uniform(0.0, 2e8), exact], np.float32)
    present = np.array([rng.random() < 0.9])
    return bs, present, n_real, channels, solve, scal


@functools.lru_cache(maxsize=None)
def pilots(n_solve):
    """The pilots of one n_solve with the plain version's (theta, flags)."""
    rng = np.random.default_rng(1_000 + n_solve)
    out = []
    for _ in range(PILOTS):
        p = random_pilot(rng, n_solve)
        bs, present, n_real, channels, solve, scal = p
        theta, flags = taqa_solve_rate_ref(
            torch.from_numpy(bs), torch.from_numpy(present), n_real,
            torch.from_numpy(channels), torch.from_numpy(solve), torch.from_numpy(scal))
        out.append((p, theta.numpy(), int(flags[0])))
    return out


@pytest.mark.parametrize("k", KS)
@pytest.mark.parametrize("n_solve", N_SOLVE)
def test_speculative_solve_is_bitwise_the_plain_version(n_solve, k):
    for p, theta, flags in pilots(n_solve):
        got, got_flags = solve_mirror(*p, k=k)
        assert got_flags == flags
        assert np.array_equal(got.view(np.int32), theta.view(np.int32)), (got, theta)


def test_random_pilots_reach_every_branch():
    """The pilots reach every branch: each flag, theta at max_rate,
    theta strictly inside, n_real 0 to 2, and a plan that goes."""
    seen = set()
    for n_solve in N_SOLVE:
        for (bs, present, n_real, channels, solve, scal), theta, flags in pilots(n_solve):
            seen.update(f"flag{b}" for b in (1, 2, 4) if flags & b)
            seen.add("at_max" if theta[0] == scal[1] else "inside")
            seen.add(f"n_real{n_real}" if n_real <= 2 else "n_real>2")
            if theta[1] != 0:
                seen.add("goes")
    assert seen >= {"flag1", "flag2", "flag4", "at_max", "inside", "n_real0", "n_real1",
                    "n_real2", "n_real>2", "goes"}, seen


def test_kernel_levels_fit_the_cta():
    for n_solve in range(1, 65):
        k = kernel_levels(n_solve)
        assert 1 <= k <= 8 and n_solve << k <= 1024
    assert [kernel_levels(n) for n in N_SOLVE] == [8, 8, 7, 4]


@pytest.mark.parametrize("k", (1, 2, 4, 7, 8))
@pytest.mark.parametrize("salt", (0x9E3779B1, 0x85EBCA77, 0xC2B2AE3D))
def test_walk_needs_no_monotone_predicate(k, salt):
    """A predicate hashed from the rate's bits flips at random along the
    path: the walk still ends bit for bit where the sequential loop does."""
    def hashed(theta):
        bits = np.asarray(theta, np.float32).view(np.uint32).astype(np.uint64)
        return (((bits * salt) >> 13) & 1).astype(bool)

    for lo, hi in ((1e-6, 1.0), (1e-9, 0.05), (0.25, 0.5)):
        want = sequential_walk(hashed, lo, hi)
        got = speculative_walk(hashed, lo, hi, k)
        assert np.float32(got[0]).view(np.int32) == np.float32(want[0]).view(np.int32)
        assert np.float32(got[1]).view(np.int32) == np.float32(want[1]).view(np.int32)


def test_walk_is_the_loop_for_a_real_predicate():
    """The solve's own feasibility (one channel) through both walks."""
    f32 = np.float32
    feasible = feasibility(np.array([2.0e9], f32), np.array([3.0e6], f32),
                           np.array([1.96], f32), np.array([2.3], f32),
                           np.array([0.05], f32), f32(1_875_000))
    want = sequential_walk(feasible, 1e-6, 1.0)
    for k in (1, 3, 8, 12):
        assert speculative_walk(feasible, 1e-6, 1.0, k) == want
    assert 1e-6 < want[1] < 1.0


@pytest.mark.parametrize("n", (1, 4095, 4096, 4097, 16_383, 16_384, 16_385, 100_000))
def test_single_pass_compaction_equals_the_plain_version(n):
    u = np.random.default_rng(n).random(n).astype(np.float32)
    for theta in (0.0, 0.0005, 0.3, 1.0, 2.0):
        want_nsel, want = taqa_draw_compact_ref(torch.from_numpy(u),
                                                torch.tensor([theta], dtype=torch.float32))
        for seed in range(3):
            scratch = DrawScratch(8)
            nsel, padded = draw_mirror(u, theta, seed, scratch)
            assert nsel == int(want_nsel[0])
            np.testing.assert_array_equal(padded, want.numpy())
            assert (scratch.epoch, scratch.ticket) == (2, 0)


def _small(u, theta, seed, scratch, resident=5):
    """Small tiles and 4-word windows: look-backs cross windows and tiles
    outnumber the resident ones."""
    return draw_mirror(u, theta, seed, scratch, rows=2, threads=64, window=4,
                       resident=resident)


def _check(u, theta, got):
    want_nsel, want = taqa_draw_compact_ref(torch.from_numpy(u),
                                            torch.tensor([theta], dtype=torch.float32))
    assert got[0] == int(want_nsel[0])
    np.testing.assert_array_equal(got[1], want.numpy())


@pytest.mark.parametrize("resident", (1, 3, 16))
def test_compaction_with_many_windows_and_few_resident_tiles(resident):
    u = np.random.default_rng(resident).random(30_000).astype(np.float32)
    for theta in (0.001, 0.3, 2.0):
        for seed in range(4):
            _check(u, theta, _small(u, theta, seed, DrawScratch(300), resident))


def test_stale_statuses_of_earlier_calls_read_as_unpublished():
    """One scratch through calls of shrinking and growing size: the words
    an earlier, larger call left behind never count."""
    rng = np.random.default_rng(5)
    scratch = DrawScratch(300)
    for i, n in enumerate((30_000, 5_000, 30_000, 100, 19_000, 30_000)):
        u = rng.random(n).astype(np.float32)
        theta = float(rng.choice([0.001, 0.3, 2.0]))
        _check(u, theta, _small(u, theta, i, scratch))
        assert (scratch.epoch, scratch.ticket) == (i + 2, 0)


def test_the_wrap_launch_clears_every_status():
    """The launch of the last epoch counts its tiles done and clears every
    status word; the epochs start again at 1 and the answers stay exact."""
    rng = np.random.default_rng(6)
    scratch = DrawScratch(300)
    for i, n in enumerate((30_000, 12_000)):          # statuses of a small epoch stay behind
        u = rng.random(n).astype(np.float32)
        _check(u, 0.3, _small(u, 0.3, i, scratch))
    scratch.epoch = LAST_EPOCH - 1
    for i, n in enumerate((20_000, 25_000, 30_000, 8_000)):
        u = rng.random(n).astype(np.float32)
        theta = float(rng.choice([0.001, 0.3]))
        _check(u, theta, _small(u, theta, 10 + i, scratch))
        if i == 1:                                    # the wrap launch
            assert not scratch.status.any() and (scratch.epoch, scratch.done) == (1, 0)
    assert scratch.epoch == 3 and scratch.ticket == 0
