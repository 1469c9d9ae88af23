"""Sampling-plan optimization (§3.2).

Plan space Θ̃ (paper, verbatim): for every subset S of the large tables and
every i ∈ S, the plan that *minimizes θ_i* subject to the conjunction of all
per-(aggregate, group) constraints φ and the domain D(Θ, S):
θ_j ∈ (0, 0.1] for j ∈ S, θ_j = 1 otherwise.

Every U_V term is monotonically decreasing in each θ (each (1−θ)/θ factor
is), so the 1-D minimization of θ_i given fixed θ_{j≠i} is solved exactly by
guarded bisection — same argmin as the paper's trust-region solver, but
deterministic and dependency-free.  Candidates are then costed with the
engine's bytes-moved model and plans costlier than the exact query are
rejected (the PilotDB fallback-to-exact rule).
"""

from __future__ import annotations

import dataclasses
import itertools
import math
from typing import Callable, Dict, List, Optional, Sequence

from repro_torch.core import bsap
from repro_torch.core.spec import SamplingPlan


@dataclasses.dataclass
class Constraint:
    """One simple-channel × group constraint φ_{i,j}(Θ)."""

    label: str
    z: float                      # z_{(1+p')/2}
    L_mu: float                   # probabilistic lower bound of the aggregate
    error: float                  # channel budget e
    var_fn: Callable[[Dict[str, float]], float]  # Θ -> U_V[Θ]

    def holds(self, rates: Dict[str, float]) -> bool:
        return bsap.phi_satisfied(self.z, self.var_fn(rates), self.L_mu, self.error)


def _feasible(constraints: Sequence[Constraint], rates: Dict[str, float]) -> bool:
    return all(c.holds(rates) for c in constraints)


def solve_candidates(
    constraints: Sequence[Constraint],
    sampleable_tables: Sequence[str],
    max_rate: float = 0.10,
    min_rate: float = 1e-6,
    max_subset: int = 2,
    bisect_iters: int = 48,
) -> List[SamplingPlan]:
    """Enumerate Θ̃: argmin_{θ_i} plans for each (S, i)."""
    out: List[SamplingPlan] = []
    tables = list(sampleable_tables)
    for r in range(1, min(len(tables), max_subset) + 1):
        for S in itertools.combinations(tables, r):
            for i in S:
                rates = {t: 1.0 for t in tables}
                for j in S:
                    rates[j] = max_rate
                if not _feasible(constraints, rates):
                    continue  # even the loosest plan in this domain fails
                lo, hi = min_rate, max_rate
                for _ in range(bisect_iters):
                    mid = math.sqrt(lo * hi)  # geometric: rates span decades
                    rates[i] = mid
                    if _feasible(constraints, rates):
                        hi = mid
                    else:
                        lo = mid
                rates[i] = hi
                out.append(SamplingPlan(rates={t: r_ for t, r_ in rates.items()}))
    return out


def pick_plan(
    candidates: List[SamplingPlan],
    cost_fn: Callable[[Dict[str, float]], float],
    exact_cost: float,
) -> Optional[SamplingPlan]:
    """Cost-based selection + rejection of plans costlier than exact (§3.2)."""
    best: Optional[SamplingPlan] = None
    for cand in candidates:
        cand.est_cost = float(cost_fn(cand.rates))
        if cand.est_cost >= exact_cost:
            continue
        if best is None or cand.est_cost < best.est_cost:
            best = cand
    return best
