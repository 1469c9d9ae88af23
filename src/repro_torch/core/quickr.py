"""Quickr-style baseline (§5.4) and the PilotDB-R ablation (§5.5).

Quickr injects *row-level uniform* samplers into the plan at query time and
needs one full pass over the data (its own paper's stated property).  We model
it as: run the same two-stage pilot machinery, but with row-level Bernoulli
statistics (the units are rows, Lemma B.1) and a row-sampled final query whose
scan cost is the full input (blocks cannot be skipped).  `quickr_bsap` is the
§5.4 augmentation: the identical planner but with BSAP block statistics and a
block-sampled final query — the speedup between the two is the paper's
Fig. 12.

In the port both the pilot and the final are row-sampled plans, so they run
through the physical layer's gather route: the host draws one uniform per
padded row (``sampling.draw_row_sample``), and the card reads every row and
reduces through one ``segment_sum`` call per query.
"""

from __future__ import annotations

import math
import time

import numpy as np

from repro_torch.core import bsap, propagation
from repro_torch.core.allocation import allocate
from repro_torch.core.spec import ErrorSpec, SamplingPlan
from repro_torch.core.taqa import ApproxAnswer, PilotDB, Query, TaqaReport, _combine
from repro_torch.engine import cost as cost_mod
from repro_torch.engine import logical as L
from repro_torch.engine.executor import EmptySampleError


class RowSamplingAQP(PilotDB):
    """PilotDB with BSAP swapped for row-level Bernoulli sampling (PilotDB-R).

    The planner uses Lemma B.1 directly (rows as units).  The final query uses
    TABLESAMPLE BERNOULLI — a full scan is paid.  This both (a) reproduces the
    Quickr cost profile and (b) is the PilotDB-R ablation row of Table 5.
    """

    def query(self, q: Query, spec: ErrorSpec, seed: int = 0) -> ApproxAnswer:
        plan, comp_channels = self._engine_plan(q)
        report = TaqaReport()
        report.exact_cost = cost_mod.exact_cost(plan, self.ex.catalog)
        report.exact_scanned_bytes = int(report.exact_cost)
        large = self._large_tables(plan)
        if not large:
            return self._exact(q, plan, comp_channels, report, "no large table")
        table = large[0]
        report.pilot_table = table

        # Row-level pilot: row Bernoulli at a rate giving >= ~1000 rows.
        n_rows = self.ex.table_rows(table)
        theta_p = max(spec.theta_pilot, min(1.0, 1000.0 / n_rows))
        report.theta_pilot = theta_p
        t0 = time.perf_counter()
        pplan = L.rewrite_scans(plan, {table: L.SampleClause("row", theta_p, seed)})
        try:
            pres = self.ex.execute(pplan)
        except EmptySampleError:
            report.pilot_time_s = time.perf_counter() - t0
            return self._exact(q, plan, comp_channels, report, "pilot sample empty")
        # Re-run with squared exprs to get row-level variances.
        sq_aggs = []
        for a in plan.aggs:
            expr = None if a.op == "count" else a.expr
            sq_aggs.append(L.AggSpec("sum", expr * expr if expr is not None else None,
                                     a.name + "_sq") if expr is not None
                           else L.AggSpec("count", None, a.name + "_sq"))
        sq_plan = L.Aggregate(pplan.child, tuple(sq_aggs), plan.group_by, plan.max_groups)
        sqres = self.ex.execute(sq_plan)
        report.pilot_time_s = time.perf_counter() - t0
        report.pilot_scanned_bytes = pres.scanned_bytes + sqres.scanned_bytes

        counts = pres.group_counts
        # The row-level estimator is N_rows × (mean over ALL kept rows,
        # zeros included for rows failing predicates/other groups), so the
        # planning moments must also be over the full kept sample — using
        # qualifying-row moments only would ignore selectivity variance.
        n_kept = pres.sample_infos[table].n_sampled_rows or 0
        if n_kept < spec.min_pilot_blocks or counts.sum() < 2:
            return self._exact(q, plan, comp_channels, report, "pilot too small")
        report.n_pilot_blocks = int(n_kept)

        # Allocate budgets & find the minimal row rate satisfying Lemma B.1.
        t0 = time.perf_counter()
        present = np.nonzero(pres.group_present)[0]
        n_constraints = sum(len(ix) for ix in comp_channels) * max(len(present), 1)
        theta_needed = 0.0
        feasible = True
        for comp, idxs in zip(q.aggs, comp_channels):
            e_part = propagation.split_budget(comp.kind, spec.error)
            for ch in idxs:
                budget = allocate(spec.confidence, n_constraints, e_part)
                for g in present:
                    if counts[g] < 2:
                        feasible = False
                        break
                    # Full-population per-row moments: zeros for rows outside
                    # the predicate/group are part of the population.
                    mean = pres.raw_sums[ch, g] / n_kept
                    mean_sq = sqres.raw_sums[ch, g] / n_kept
                    var = max(mean_sq - mean ** 2, 0.0)
                    L_mu, U_V = bsap.naive_row_bounds(
                        mean, var, int(n_kept), theta_p, budget.delta1, budget.delta2,
                        exact_N=float(n_rows))
                    if L_mu <= 0:
                        feasible = False
                        break
                    z = bsap.z_for(budget.p_prime)
                    lo, hi = 1e-6, spec.max_final_rate
                    if not bsap.phi_satisfied(z, U_V(hi), L_mu, budget.error):
                        feasible = False
                        break
                    for _ in range(48):
                        mid = math.sqrt(lo * hi)
                        if bsap.phi_satisfied(z, U_V(mid), L_mu, budget.error):
                            hi = mid
                        else:
                            lo = mid
                    theta_needed = max(theta_needed, hi)
                if not feasible:
                    break
            if not feasible:
                break
        report.plan_time_s = time.perf_counter() - t0
        if not feasible or theta_needed <= 0:
            return self._exact(q, plan, comp_channels, report, "row plan infeasible")

        report.plan = SamplingPlan(rates={table: theta_needed})
        t0 = time.perf_counter()
        fplan = L.rewrite_scans(plan, {table: L.SampleClause("row", theta_needed, seed + 977)})
        try:
            res = self.ex.execute(fplan)
        except EmptySampleError as e:
            report.final_time_s = time.perf_counter() - t0
            return self._exact(q, plan, comp_channels, report,
                               f"final sample empty ({e.table})")
        report.final_time_s = time.perf_counter() - t0
        report.final_scanned_bytes = res.scanned_bytes
        values = _combine(q, comp_channels, res.values)
        return ApproxAnswer([c.name for c in q.aggs], values, res.group_present, report)
