"""Approximate evaluation with a-priori error guarantees (the paper's
technique as a first-class training-framework feature).

Evaluating a model on a large held-out corpus is exactly the workload
PilotDB targets: an aggregation (mean loss / accuracy) over a huge table
whose scan cost dominates.  Here the "table" is the eval corpus, a "block"
is one shard slab of `block_seqs` sequences (the unit the storage layer
serves), and "scanning a block" is running the model's forward pass on it.
TAQA's two stages become:

  pilot:  run the model on a few sampled blocks, collect per-block sums;
  plan:   BSAP single-table bounds (Lemma B.1 at block level) give the
          minimal block-sampling rate whose CLT interval meets (e, p);
  final:  run the model on the planned sample only, report the Hájek
          estimate — with P[|rel err| <= e] >= p, decided *before* the
          expensive evaluation runs.

Speedup = blocks actually evaluated / total blocks, typically 10-100×
for loose (5-10%) eval-loss tolerances — same economics as the paper's
Fig. 8, with TPU-hours instead of I/O as the saved resource.

The port's copy: the imports are rewired to the port's own statistics, and
the host draws stay ``np.random.default_rng(seed)``, so equal seeds give the
reference's pilot and final shard ids.  The model behind ``block_metric``
runs on the card (``examples/torch_approx_eval.py``).
"""

from __future__ import annotations

import dataclasses
import math
from typing import Callable, Dict, Optional

import numpy as np

from repro_torch.core import bsap
from repro_torch.core.allocation import allocate
from repro_torch.stats import normal_ppf


@dataclasses.dataclass
class ApproxEvalResult:
    estimate: float
    error_bound: float
    confidence: float
    pilot_blocks: int
    final_blocks: int
    total_blocks: int
    theta: float
    exact: bool = False

    @property
    def blocks_saved_frac(self) -> float:
        used = self.pilot_blocks + self.final_blocks
        return 1.0 - min(used / max(self.total_blocks, 1), 1.0)


class GuaranteedEvaluator:
    """Plans and runs a guaranteed-error approximate evaluation.

    block_metric(block_indices) -> (sums, counts): per-block metric sums and
    element counts for the requested blocks (i.e. "run the model on these
    shards").  The estimated quantity is total_sum / total_count (mean
    metric), a ratio of two totals — both planned via the corrected division
    rule (Table 2).
    """

    def __init__(self, num_blocks: int,
                 block_metric: Callable[[np.ndarray], tuple],
                 *, seed: int = 0):
        self.n = num_blocks
        self.block_metric = block_metric
        self.rng = np.random.default_rng(seed)

    def evaluate(self, *, error: float, confidence: float,
                 pilot_blocks: int = 24, max_rate: float = 0.5) -> ApproxEvalResult:
        n = self.n
        theta_p = min(max(pilot_blocks / n, 1e-6), 1.0)
        keep = self.rng.random(n) < theta_p
        pilot_ids = np.nonzero(keep)[0]
        if len(pilot_ids) < 2:
            pilot_ids = self.rng.choice(n, size=min(2, n), replace=False)
        sums, counts = self.block_metric(pilot_ids)
        sums, counts = np.asarray(sums, float), np.asarray(counts, float)

        # ratio composite: numerator (sum of metric) and denominator (count)
        e_part = error / (2.0 + error)
        budgets = [allocate(confidence, 2, e_part) for _ in range(2)]
        theta_req = 0.0
        feasible = True
        for y, budget in zip((sums, counts), budgets):
            L_mu = n * bsap.block_mean_lower(y, budget.delta1)
            if not np.isfinite(L_mu) or L_mu <= 0:
                feasible = False
                break
            uv = bsap.single_table_var_ub(y, theta_p, budget.delta2, n_blocks=n)
            z = bsap.z_for(budget.p_prime)
            lo, hi = 1e-6, max_rate
            if not bsap.phi_satisfied(z, uv(hi), L_mu, budget.error):
                feasible = False
                break
            for _ in range(48):
                mid = math.sqrt(lo * hi)
                if bsap.phi_satisfied(z, uv(mid), L_mu, budget.error):
                    hi = mid
                else:
                    lo = mid
            theta_req = max(theta_req, hi)

        if not feasible:
            # exact fallback: evaluate everything (guarantee trivially holds)
            ids = np.arange(n)
            s, c = self.block_metric(ids)
            return ApproxEvalResult(float(np.sum(s) / np.sum(c)), error,
                                    confidence, len(pilot_ids), int(n), n,
                                    1.0, exact=True)

        keep = self.rng.random(n) < theta_req
        ids = np.nonzero(keep)[0]
        if len(ids) == 0:
            ids = self.rng.choice(n, size=1)
        s, c = self.block_metric(ids)
        est = float(np.sum(s) / np.maximum(np.sum(c), 1e-12))
        return ApproxEvalResult(est, error, confidence, len(pilot_ids),
                                int(len(ids)), n, float(theta_req))
