"""Plain PyTorch versions of the taqa_solve kernels (the CPU route and the
kernels' yardstick in tests and ``chip_smoke.py``).

:func:`taqa_solve_rate_ref` is the reference's f32 rate solve
(``src/repro/engine/physical.py:1163-1209``), one tensor op per operation so
each rounds once, with s1 and s2 added in the kernel's order (thread t of
256 adds rows t, t + 256, ... in row order, a xor butterfly over each warp's
32 lanes, then the 8 warp sums in order): the kernel and this version give
the same bits.  :func:`taqa_draw_compact_ref` is the final draw and its
stream compaction, ``torch.nonzero`` of the kept uniforms.
"""

from __future__ import annotations

from typing import Tuple

import torch

THREADS = 256        # csrc kThreads
WARP = 32
STEPS = 48           # bisection steps (csrc kSteps)


def _ordered_sum(y: torch.Tensor) -> torch.Tensor:
    """Column sums of ``y`` (rows, k) f32 in the kernel's order."""
    rows, k = y.shape
    acc = torch.zeros((THREADS, k), dtype=torch.float32, device=y.device)
    for start in range(0, rows, THREADS):
        step = y[start:start + THREADS]
        if step.shape[0] < THREADS:  # the last step: + 0 leaves a sum's bits
            step = torch.cat([step, acc.new_zeros((THREADS - step.shape[0], k))])
        acc = acc + step
    lanes = acc.reshape(THREADS // WARP, WARP, k)
    lane = torch.arange(WARP, device=y.device)
    off = WARP // 2
    while off:
        lanes = lanes + lanes[:, lane ^ off]
        off //= 2
    total = lanes[0, 0]
    for w in range(1, THREADS // WARP):
        total = total + lanes[w, 0]
    return total


def taqa_solve_rate_ref(block_sums: torch.Tensor, present: torch.Tensor, n_real: int,
                        channels: torch.Tensor, solve: torch.Tensor,
                        scal: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Same function as the ``taqa_solve_rate`` kernel: ``(theta (2,) f32
    [theta, theta_eff], flags (1,) int32)``; see :func:`ops.taqa_solve_rate`."""
    f32 = torch.float32
    dev = block_sums.device
    c = lambda v: torch.tensor(v, dtype=f32, device=dev)
    y = block_sums[:, channels.long()]
    s1 = _ordered_sum(y)
    s2 = _ordered_sum(y * y)
    n = c(float(n_real))
    N, max_rate, min_rate = scal[0], scal[1], scal[2]
    cost_a, cost_b, exact_cost = scal[3], scal[4], scal[5]
    t_q, chi_q, z, z_bin, e = (solve[:, i] for i in range(5))
    mean = s1 / n
    var = torch.maximum((s2 - s1 * s1 / n) / torch.maximum(n - 1.0, c(1.0)), c(0.0))
    L_mu = N * (mean - t_q * torch.sqrt(var) / torch.sqrt(n))
    var_ub = (n - 1.0) / torch.maximum(chi_q, c(1e-12)) * var
    L_ok = bool(torch.all((L_mu > 0.0) & torch.isfinite(L_mu)))

    def feasible(theta: torch.Tensor) -> bool:
        one_minus = 1.0 - theta
        n_theta = N * theta
        spread = torch.sqrt(torch.maximum(n_theta * one_minus, c(0.0)))
        n_lb = torch.maximum(n_theta - z_bin * spread, c(0.0))
        u_v = torch.where(n_lb > 1.0,
                          N * N * one_minus * var_ub / torch.maximum(n_lb, c(1e-30)),
                          c(float("inf")))
        u_v = torch.where(theta >= 1.0, c(0.0), u_v)
        ok = (L_mu > 0.0) & (z * torch.sqrt(torch.maximum(u_v, c(0.0))) <= e * L_mu)
        return bool(torch.all(ok))

    feas_max = feasible(max_rate)
    lo, hi = min_rate, max_rate
    for _ in range(STEPS):
        mid = torch.sqrt(lo * hi)  # geometric: rates span decades
        if feasible(mid):
            hi = mid
        else:
            lo = mid
    theta = hi
    have_plan = feas_max and bool(cost_a * theta + cost_b < exact_cost)
    has_groups = bool(present[0])
    go = has_groups and L_ok and have_plan
    flags = (0 if has_groups else 1) + (0 if L_ok else 2) + (0 if have_plan else 4)
    out = torch.stack([theta, theta if go else c(0.0)])
    return out, torch.tensor([flags], dtype=torch.int32, device=dev)


def taqa_draw_compact_ref(u: torch.Tensor,
                          theta_eff: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Same function as the ``taqa_draw_compact`` kernel: ``(nsel (1,)
    int32, padded (N,) int32)``, the indices with ``u < theta_eff`` in
    ascending order, zero past nsel."""
    ids = torch.nonzero(u < theta_eff).flatten().to(torch.int32)
    padded = torch.zeros(u.shape[0], dtype=torch.int32, device=u.device)
    padded[:ids.shape[0]] = ids
    return torch.tensor([ids.shape[0]], dtype=torch.int32, device=u.device), padded
