"""numpy mirrors of the taqa_solve CUDA kernels' parallel orders
(``kernels/taqa_solve/csrc/taqa_solve.cu``).

* :func:`solve_mirror` — ``taqa_solve_rate`` with its bisection run as the
  kernel runs it: rounds of k levels, every path of a round evaluated
  speculatively from the round's root (:func:`speculative_walk`), f32
  throughout.  The CPU tests hold it, for several k, bit for bit to the
  plain version's sequential loop; the card tests hold the kernel to it.
* :func:`draw_mirror` — ``taqa_draw_compact``'s single-pass compaction
  replayed tile by tile in a seeded random order that keeps only the
  kernel's ordering edges: tickets in index order, a tile's zeros before
  its aggregate status, a look-back that spins until the statuses it needs
  carry this launch's epoch, its inclusive status, then its scatter; at
  most ``resident`` tiles at once; on a scratch that lives from call to
  call (:class:`DrawScratch`).  A violated edge would leave a zero over an
  id in some order; a stale status read as published, a wrong count.

Imports numpy and the port only, so it runs where JAX is absent.
"""

import numpy as np

from repro_torch.kernels.taqa_solve import ops as taqa_ops
from repro_torch.kernels.taqa_solve import ref as taqa_ref

F32 = np.float32
STEPS = taqa_ref.STEPS
THREADS = taqa_ref.THREADS
WARP = taqa_ref.WARP
TILE_ROWS = taqa_ops.TILE_ROWS
DRAW_THREADS = taqa_ops.DRAW_THREADS
LOOK_WINDOW = 128        # status words of one look-back window (csrc 32 * kLookWords)
MAX_THREADS = 1024       # csrc kMaxSolveThreads
MAX_LEVELS = 8           # csrc kMaxLevels
AGGREGATE, INCLUSIVE = 1, 2


def kernel_levels(n_solve: int) -> int:
    """The k the kernel's launch picks (csrc solve_levels)."""
    k = MAX_LEVELS
    while (n_solve << k) > MAX_THREADS:
        k -= 1
    return k


def ordered_sums(y: np.ndarray) -> np.ndarray:
    """Column sums of ``y`` (rows, c) f32 in the kernel's order: thread t of
    256 adds rows t, t + 256, ..., a xor butterfly per warp, the 8 warp sums
    in order."""
    rows, c = y.shape
    acc = np.zeros((THREADS, c), F32)
    for start in range(0, rows, THREADS):
        step = y[start:start + THREADS]
        acc[:step.shape[0]] = acc[:step.shape[0]] + step
    lanes = acc.reshape(THREADS // WARP, WARP, c)
    off = WARP // 2
    while off:
        lanes = lanes + lanes[:, np.arange(WARP) ^ off]
        off //= 2
    total = lanes[0, 0]
    for w in range(1, THREADS // WARP):
        total = total + lanes[w, 0]
    return total


def feasibility(L_mu, var_ub, z, z_bin, e, N):
    """The reference's ``feasible`` as a function of an f32 array of rates:
    (m,) -> (m,) bool, every channel's term evaluated as one f32 array op
    over (m, n_solve)."""
    zero, one = F32(0.0), F32(1.0)

    def feasible(theta):
        th = np.asarray(theta, F32)[:, None]
        with np.errstate(all="ignore"):
            one_minus = one - th
            n_theta = N * th
            spread = np.sqrt(np.maximum(n_theta * one_minus, zero))
            n_lb = np.maximum(n_theta - z_bin * spread, zero)
            u_v = np.where(n_lb > one,
                           N * N * one_minus * var_ub / np.maximum(n_lb, F32(1e-30)),
                           F32(np.inf))
            u_v = np.where(th >= one, zero, u_v).astype(F32)
            ok = (L_mu > zero) & (z * np.sqrt(np.maximum(u_v, zero)) <= e * L_mu)
        return ok.all(axis=1)

    return feasible


def sequential_walk(feasible, lo, hi, steps=STEPS):
    """The plain loop: ``steps`` dependent bisection steps."""
    lo, hi = F32(lo), F32(hi)
    for _ in range(steps):
        mid = np.sqrt(F32(lo * hi), dtype=F32)
        if feasible(np.array([mid], F32))[0]:
            hi = mid
        else:
            lo = mid
    return lo, hi


def speculative_walk(feasible, lo, hi, k, steps=STEPS):
    """The kernel's bisection: rounds of ``k`` levels (fewer in the last).
    Path p (heap node p - 1; children 2p for infeasible, 2p + 1 for
    feasible) replays its bits below the leading one from the round's root
    with the loop's operations; all paths are tested as one array; the
    walk from path 1 along the results reaches the round's last level, and
    that path's interval gives the next root."""
    lo, hi = F32(lo), F32(hi)
    done = 0
    while done < steps:
        lv = min(k, steps - done)
        path = np.arange(1, 1 << lv, dtype=np.int64)
        depth = np.frexp(path.astype(np.float64))[1] - 1        # bit length - 1
        plo = np.full(path.shape, lo, F32)
        phi = np.full(path.shape, hi, F32)
        for s in range(lv - 1):                                 # step s from the root
            take = depth > s
            bit = (path >> np.maximum(depth - 1 - s, 0)) & 1
            m = np.sqrt(plo * phi)
            plo = np.where(take & (bit == 0), m, plo)
            phi = np.where(take & (bit == 1), m, phi)
        mid = np.sqrt(plo * phi)
        res = np.asarray(feasible(mid), bool)
        p = 1
        for _ in range(lv - 1):
            p = 2 * p + int(res[p - 1])
        e = p - 1
        lo, hi = (plo[e], mid[e]) if res[e] else (mid[e], phi[e])
        done += lv
    return lo, hi


def solve_mirror(block_sums, present, n_real, channels, solve, scal, k=None):
    """``taqa_solve_rate`` on numpy inputs with its bisection in rounds of
    ``k`` levels (the kernel's own k by default): ``(theta (2,) f32 [theta,
    theta_eff], flags int)``."""
    bs = np.asarray(block_sums, F32)
    solve = np.asarray(solve, F32)
    N, max_rate, min_rate, cost_a, cost_b, exact_cost = (F32(v) for v in np.asarray(scal, F32))
    y = bs[:, np.asarray(channels, np.int64)]
    s1 = ordered_sums(y)
    s2 = ordered_sums(y * y)
    n = F32(n_real)
    t_q, chi_q, z, z_bin, e = (solve[:, i] for i in range(5))
    with np.errstate(all="ignore"):
        mean = s1 / n
        var = np.maximum((s2 - s1 * s1 / n) / np.maximum(n - F32(1.0), F32(1.0)), F32(0.0))
        L_mu = N * (mean - t_q * np.sqrt(var) / np.sqrt(n))
        var_ub = (n - F32(1.0)) / np.maximum(chi_q, F32(1e-12)) * var
    L_ok = bool(np.all((L_mu > 0) & np.isfinite(L_mu)))
    feasible = feasibility(L_mu, var_ub, z, z_bin, e, N)
    feas_max = bool(feasible(np.array([max_rate], F32))[0])
    _, theta = speculative_walk(feasible, min_rate, max_rate,
                                kernel_levels(len(channels)) if k is None else k)
    have_plan = feas_max and bool(F32(cost_a * theta) + cost_b < exact_cost)
    has_groups = bool(np.asarray(present).reshape(-1)[0])
    go = has_groups and L_ok and have_plan
    flags = (0 if has_groups else 1) + (0 if L_ok else 2) + (0 if have_plan else 4)
    return np.array([theta, theta if go else F32(0.0)], F32), flags


def _tile_ranks(keep, rows, threads):
    """Rank of each kept slot of a tile among the tile's: the (row, warp)
    counts' exclusive scan plus the lanes below in the warp's ballot."""
    k = keep.reshape(rows, threads // WARP, WARP)
    counts = k.sum(axis=2).reshape(-1)
    offs = (np.cumsum(counts) - counts).reshape(rows, threads // WARP, 1)
    lane_rank = np.cumsum(k, axis=2) - k
    return (offs + lane_rank).reshape(-1), int(counts.sum())


LAST_EPOCH = 2 ** 32 - 1  # csrc kLastEpoch


class DrawScratch:
    """The compaction's scratch as the wrapper makes it: epoch 1, ticket 0,
    no status published.  ``status`` rows are (epoch, inclusive, count)."""

    def __init__(self, max_tiles):
        self.epoch, self.ticket, self.done = 1, 0, 0
        self.status = np.zeros((max_tiles, 3), np.int64)


def draw_mirror(u, theta, seed, scratch=None, rows=TILE_ROWS, threads=DRAW_THREADS,
                window=LOOK_WINDOW, resident=8):
    """``taqa_draw_compact`` on numpy inputs, tiles of ``rows * threads``
    uniforms interleaved in a random order (``seed``) that keeps the
    kernel's ordering edges, on ``scratch`` (a fresh one if None), which it
    leaves as the kernel leaves it: the ticket at zero, the epoch advanced,
    and, after the launch of the last epoch, every status cleared.  A
    status word of another epoch reads as unpublished.  Returns ``(nsel,
    padded)``."""
    u = np.asarray(u, F32)
    theta = F32(theta)
    n = u.shape[0]
    tile_n = rows * threads
    n_tiles = -(-n // tile_n)
    if scratch is None:
        scratch = DrawScratch(n_tiles)
    status = scratch.status
    rng = np.random.default_rng(seed)
    padded = np.full(n, -7, np.int32)                 # what torch.empty might hold
    nsel = [None]
    active = {}                                       # tile -> generator of its steps

    def take_ticket():
        epoch, tile = scratch.epoch, scratch.ticket   # one atomicAdd on (epoch, ticket)
        scratch.ticket += 1
        if tile == n_tiles - 1:                       # every ticket of this launch is taken
            scratch.epoch, scratch.ticket = (1 if epoch == LAST_EPOCH else epoch + 1), 0
        return epoch, tile

    def tile_steps(epoch, b):
        base = b * tile_n
        idx = base + np.arange(tile_n)
        live = idx < n
        vals = np.where(live, u[np.minimum(idx, n - 1)], F32(1.0))
        keep = live & (vals < theta)
        padded[idx[live]] = 0                          # its own range, before its aggregate
        ranks, agg = _tile_ranks(keep, rows, threads)
        yield
        status[b] = (epoch, int(b == 0), agg)
        yield
        excl, end = 0, b - 1
        while b > 0:                                   # the look-back, a window a step
            slots = end - np.arange(window)
            words = np.where(slots[:, None] >= 0, status[np.maximum(slots, 0)],
                             (epoch, 1, 0))
            incl = np.flatnonzero((words[:, 0] == epoch) & (words[:, 1] == 1))
            first = incl[0] if incl.size else window
            if np.any(words[:first + 1, 0] != epoch):
                yield                                  # spin: read the window again
                continue
            excl += int(words[:first + 1, 2].sum())
            if incl.size:
                break
            end -= window
            yield
        status[b] = (epoch, 1, excl + agg)
        if b == n_tiles - 1:
            nsel[0] = excl + agg
        clear = False
        if epoch == LAST_EPOCH:                        # the wrap launch counts its tiles done
            scratch.done += 1
            clear = scratch.done == n_tiles
        yield
        for part in np.array_split(np.flatnonzero(keep), 3):   # the scatter, interleaved
            padded[excl + ranks[part]] = idx[part]
            yield
        if clear:                                      # every look-back is over
            status[:] = 0
            scratch.done = 0

    started = 0
    for _ in range(10_000 * (n_tiles + 1)):
        if started == n_tiles and not active:
            break
        can_start = started < n_tiles and len(active) < resident
        pick = rng.integers(len(active) + int(can_start))
        if pick == len(active):                        # the next ticket, in index order
            epoch, b = take_ticket()
            started += 1
            active[b] = tile_steps(epoch, b)
            pick = b
        else:
            pick = sorted(active)[pick]
        try:
            next(active[pick])
        except StopIteration:
            del active[pick]
    else:
        raise RuntimeError(f"the compaction made no progress: tiles {sorted(active)} wait")
    return nsel[0], padded
