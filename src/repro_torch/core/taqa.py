"""TAQA — Two-stage Approximate Query Algorithm (§3) — the PilotDB driver.

Stage 1 (sample planning): rewrite Q_in into Q_pilot (block sampling at θ_p on
the most expensive-to-scan table, aggregates grouped by physical block), run
it, and turn the pilot block statistics into per-channel probabilistic bounds
(L_μ, U_V[Θ]) via BSAP.  Stage 2: solve the sampling-plan optimization, rewrite
Q_in into Q_final with the winning plan, execute, and Horvitz–Thompson-combine
the channels into user-facing estimates.  Any failure (too-few pilot blocks,
non-positive L_μ, no feasible plan, plan costlier than exact) falls back to
exact execution — PilotDB never returns an unguaranteed estimate.

The pilot and the final each run as one compiled call on the device (the
hand-written column kernels for the single-table shapes, the gather route
and its segmented-sum kernel for GROUP BY, joins, unions and the rest), and
the rate solve runs on the host in f64, exactly as in the reference.  A
drain group's finals run through :meth:`PilotDB.run_finals_batched` (one
batched call per same-signature bucket); its pilots through
:meth:`PilotDB.run_pilots_batched`, which runs each member's solo pilot.
The fused and advisory paths wait for later slices of the port.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Callable, Dict, List, Optional, Tuple

import numpy as np

from repro_torch.core import bsap, propagation
from repro_torch.core.allocation import ChannelBudget, allocate
from repro_torch.core.planner import Constraint, pick_plan, solve_candidates
from repro_torch.core.spec import CompositeAgg, ErrorSpec, SamplingPlan
from repro_torch.engine import cost as cost_mod
from repro_torch.engine import logical as L
from repro_torch.engine.executor import EmptySampleError, Executor, PilotStats


@dataclasses.dataclass(frozen=True)
class Query:
    """User query: relational child plan + composite aggregates (§2.3)."""

    child: L.Plan
    aggs: Tuple[CompositeAgg, ...]
    group_by: Optional[str] = None
    max_groups: int = 1


@dataclasses.dataclass
class TaqaReport:
    pilot_table: Optional[str] = None
    theta_pilot: float = 0.0
    n_pilot_blocks: int = 0
    plan: Optional[SamplingPlan] = None
    fallback: Optional[str] = None        # reason, if exact execution was used
    num_channels: int = 0
    exact_cost: float = 0.0
    pilot_time_s: float = 0.0
    plan_time_s: float = 0.0
    final_time_s: float = 0.0
    pilot_scanned_bytes: int = 0
    final_scanned_bytes: int = 0
    exact_scanned_bytes: int = 0
    candidates: int = 0
    group_coverage_guaranteed: bool = True
    # True when a pilot stage actually executed for this query (False for
    # pre-pilot fallbacks: no large table, strict-coverage violation).
    pilot_ran: bool = False
    # True when this answer reused another structurally identical query's
    # pilot statistics (the runtime's one-pilot-per-group fan-out); the
    # pilot_* fields then describe that shared pilot stage.
    pilot_shared: bool = False


@dataclasses.dataclass
class ApproxAnswer:
    names: List[str]
    values: np.ndarray          # (num_composites, max_groups)
    group_present: np.ndarray   # (max_groups,)
    report: TaqaReport

    def scalar(self, name: str, group: int = 0) -> float:
        return float(self.values[self.names.index(name), group])


def _decompose(aggs: Tuple[CompositeAgg, ...]) -> Tuple[List[L.AggSpec], List[Tuple[int, ...]]]:
    """Composite aggregates -> simple engine channels (§3.3 pilot step 3)."""
    specs: List[L.AggSpec] = []
    comp_channels: List[Tuple[int, ...]] = []
    for comp in aggs:
        idxs = []
        if comp.kind == "sum":
            specs.append(L.AggSpec("sum", comp.expr, f"ch{len(specs)}"))
            idxs.append(len(specs) - 1)
        elif comp.kind == "count":
            specs.append(L.AggSpec("count", None, f"ch{len(specs)}"))
            idxs.append(len(specs) - 1)
        elif comp.kind == "avg":
            specs.append(L.AggSpec("sum", comp.expr, f"ch{len(specs)}"))
            idxs.append(len(specs) - 1)
            specs.append(L.AggSpec("count", None, f"ch{len(specs)}"))
            idxs.append(len(specs) - 1)
        elif comp.kind in ("ratio", "product", "add"):
            specs.append(L.AggSpec("sum", comp.expr, f"ch{len(specs)}"))
            idxs.append(len(specs) - 1)
            specs.append(L.AggSpec("sum", comp.expr2, f"ch{len(specs)}"))
            idxs.append(len(specs) - 1)
        else:
            raise ValueError(comp.kind)
        comp_channels.append(tuple(idxs))
    return specs, comp_channels


def build_engine_plan(q: Query) -> Tuple[L.Aggregate, List[Tuple[int, ...]]]:
    """Lower a user query to the engine plan: composites decomposed into
    simple channels under one terminal Aggregate (§3.3 pilot step 3)."""
    specs, comp_channels = _decompose(q.aggs)
    plan = L.Aggregate(child=q.child, aggs=tuple(specs),
                       group_by=q.group_by, max_groups=q.max_groups)
    return plan, comp_channels


def structural_signature(q: Query) -> L.Aggregate:
    """Hashable structural identity of a query's physical shape, predicate
    constants INCLUDED.

    Two queries with equal signatures lower to the same engine plan modulo
    TABLESAMPLE clauses.  This constant-bearing key is what pilot *sharing*
    and pilot-seed derivation must use: pilot block statistics depend on
    predicate selectivity, so sharing a pilot across different constants
    would silently break the §4 error guarantees even though the queries
    compile to one executable.
    """
    plan, _ = build_engine_plan(q)
    return L.strip_samples(plan)


def template_signature(q: Query) -> L.Plan:
    """The constant-stripped structural signature: :func:`structural_signature`
    with every predicate/expression constant hoisted into a Param slot.

    Queries agreeing on it share every callable the physical layer compiles
    (constants enter at run time as the params operand), so the scheduler
    groups submissions by it: a herd differing only in WHERE constants
    drains as one group and its finals can launch as one batched kernel.
    Pilot sharing inside the group still keys on the full signature.
    """
    from repro_torch.engine.physical import plan_template  # memoized
    return plan_template(structural_signature(q))


def pilot_params(spec: ErrorSpec) -> Tuple:
    """The ErrorSpec fields that shape the *pilot* stage (and nothing else).

    theta_p and the retry loop depend only on these — never on the error /
    confidence targets, which enter at stage 2.  Two queries with equal
    structural signatures and equal pilot params run byte-identical pilots,
    which is the key a shared-pilot runtime groups by.
    """
    return (spec.theta_pilot, spec.min_pilot_blocks, spec.max_pilot_rate,
            spec.group_min_size, spec.group_miss_prob,
            spec.strict_group_coverage)


@dataclasses.dataclass
class FinalStage:
    """One query's stage 2, planned but (possibly) not yet executed.

    :meth:`PilotDB.prepare_final` runs the planning half — constraints,
    sampling-plan optimization, the final-plan rewrite — and returns this.
    When planning short-circuits (pilot fallback, infeasible constraints, no
    plan cheaper than exact), ``answer`` is already set; otherwise
    ``final_plan`` awaits execution via :meth:`PilotDB.run_final`.
    """

    q: Query
    spec: ErrorSpec
    plan: "L.Aggregate"
    comp_channels: List[Tuple[int, ...]]
    report: TaqaReport
    final_plan: Optional["L.Aggregate"] = None
    answer: Optional[ApproxAnswer] = None


@dataclasses.dataclass
class PilotOutcome:
    """Everything stage 1 produces, reusable across same-signature queries.

    ``fallback`` records a pilot-stage reason to execute exactly (no large
    table, pilot too small, no groups, strict-coverage violation); each
    query finishing from this outcome then takes its own exact path.  The
    ``report`` is a template — :meth:`PilotDB.finish_from_pilot` copies it
    per query before filling stage-2 fields.
    """

    plan: "L.Aggregate"
    comp_channels: List[Tuple[int, ...]]
    report: TaqaReport
    pilot: Optional[PilotStats] = None
    pilot_table: Optional[str] = None
    pair_tables: Tuple[str, ...] = ()
    theta_p: float = 0.0
    fallback: Optional[str] = None


class PilotDB:
    """The middleware.  `query()` is the user entry point (Fig. 2 workflow).

    This is the internal representation's driver; the public front door is
    :class:`repro_torch.api.Session`, which owns an instance of this class per
    session and derives per-query seeds from the session PRNG.
    """

    def __init__(self, executor: Executor, large_table_rows: int = 50_000):
        self.ex = executor
        self.large_table_rows = large_table_rows

    # -- helpers -------------------------------------------------------------
    def _engine_plan(self, q: Query) -> Tuple[L.Aggregate, List[Tuple[int, ...]]]:
        return build_engine_plan(q)

    def _large_tables(self, plan: L.Aggregate) -> List[str]:
        seen: Dict[str, None] = {}
        for s in plan.scans():
            if self.ex.table_rows(s.table) >= self.large_table_rows:
                seen.setdefault(s.table, None)
        return sorted(seen, key=lambda t: -self.ex.table_bytes(t))

    def _exact(self, q: Query, plan: L.Aggregate, comp_channels, report: TaqaReport,
               reason: str) -> ApproxAnswer:
        report.fallback = reason
        t0 = time.perf_counter()
        res = self.ex.execute(L.strip_samples(plan))
        report.final_time_s = time.perf_counter() - t0
        report.final_scanned_bytes = res.scanned_bytes
        values = _combine(q, comp_channels, res.values)
        return ApproxAnswer([c.name for c in q.aggs], values, res.group_present, report)

    # -- the two-stage algorithm ----------------------------------------------
    def query(self, q: Query, spec: ErrorSpec, seed: int = 0,
              pilot_seed: Optional[int] = None) -> ApproxAnswer:
        """Full TAQA: pilot stage then final stage.

        ``seed`` drives the *final* sampled scan; ``pilot_seed`` (defaulting
        to ``seed``) drives the pilot sample.  Callers that share one pilot
        across structurally identical queries (the reference's ``runtime``) derive
        ``pilot_seed`` from the plan signature so a query answered from a
        shared pilot is bit-identical to the same query run solo.
        """
        outcome = self.run_pilot(
            q, spec, seed if pilot_seed is None else pilot_seed)
        return self.finish_from_pilot(q, spec, outcome, seed)

    def run_pilot(self, q: Query, spec: ErrorSpec,
                  pilot_seed: int) -> "PilotOutcome":
        """Stage 1: rewrite to Q_pilot, run it, collect per-block statistics.

        The returned :class:`PilotOutcome` is spec-dependent only through the
        pilot-stage tunables (theta_pilot / min_pilot_blocks / max_pilot_rate
        / group coverage) — see :func:`pilot_params`.  Queries agreeing on
        those fields and on the sampling-stripped plan signature can share
        one outcome and finish independently via :meth:`finish_from_pilot`.
        """
        outcome, theta_p = self._pilot_prelude(q, spec)
        if outcome.fallback is not None:
            return outcome
        return self._pilot_scan(outcome, spec, theta_p, pilot_seed)

    def _pilot_prelude(self, q: Query,
                       spec: ErrorSpec) -> Tuple["PilotOutcome", float]:
        """Everything stage 1 decides BEFORE any device work: cost model,
        pilot-table election, theta_p, group-coverage checks, pair tables.
        Pure host computation with no counters — a prelude-level fallback
        (no large table, strict coverage violated) never counts as a pilot
        stage, matching the pre-refactor ``run_pilot``."""
        plan, comp_channels = self._engine_plan(q)
        report = TaqaReport()
        report.exact_cost = cost_mod.exact_cost(plan, self.ex.catalog)
        # bytes accounting: full row bytes of every scanned table, matching
        # the samplers' scanned_bytes semantics (row-store physical reads)
        report.exact_scanned_bytes = sum(
            self.ex.table_bytes(s.table) for s in plan.scans())
        outcome = PilotOutcome(plan=plan, comp_channels=comp_channels,
                               report=report)

        large = self._large_tables(plan)
        if not large:
            outcome.fallback = "no large table to sample"
            return outcome, 0.0
        pilot_table = large[0]
        report.pilot_table = pilot_table
        outcome.pilot_table = pilot_table

        n_blocks = self.ex.table_blocks(pilot_table)
        block_rows = self.ex.block_rows(pilot_table)
        # 1.5x margin over the minimum pilot size: Bernoulli undershoot
        # would otherwise force a re-pilot at 4x the rate (latency spike)
        theta_p = max(spec.theta_pilot,
                      min(1.0, 1.5 * spec.min_pilot_blocks / n_blocks))
        if q.group_by is not None:
            theta_cov = bsap.group_coverage_rate(
                n_blocks, block_rows, spec.group_min_size, spec.group_miss_prob)
            if theta_cov > spec.max_pilot_rate:
                if spec.strict_group_coverage:
                    outcome.fallback = (
                        f"group coverage for g={spec.group_min_size} needs "
                        f"theta_p={theta_cov:.3f} > pilot cap (strict mode)")
                    return outcome, theta_p
                report.group_coverage_guaranteed = False
                theta_p = max(theta_p, spec.max_pilot_rate)
            else:
                theta_p = max(theta_p, theta_cov)
        theta_p = min(theta_p, 1.0)

        pair_tables: Tuple[str, ...] = ()
        if q.group_by is None and len(large) > 1:
            pair_tables = (large[1],)
        outcome.pair_tables = pair_tables
        return outcome, theta_p

    def _pilot_scan(self, outcome: "PilotOutcome", spec: ErrorSpec,
                    theta_p: float, pilot_seed: int) -> "PilotOutcome":
        """The device half of stage 1: the pilot scan with its Bernoulli
        undershoot retries (one pilot STAGE however many retries), then the
        shared postlude."""
        plan, pilot_table = outcome.plan, outcome.pilot_table
        n_blocks = self.ex.table_blocks(pilot_table)
        pilot: Optional[PilotStats] = None
        # one pilot STAGE, however many undershoot retries it takes — the
        # counter the runtime's sharing tests and benchmarks assert against
        self.ex._count("pilots_run")
        t0 = time.perf_counter()
        for attempt in range(3):
            pilot = self.ex.execute_pilot(plan, pilot_table, theta_p,
                                          pilot_seed + 101 * attempt,
                                          pair_tables=outcome.pair_tables)
            if pilot.n_sampled_blocks >= min(spec.min_pilot_blocks, n_blocks):
                break
            theta_p = min(theta_p * 4.0, 1.0)
        return self._pilot_postlude(outcome, pilot, theta_p,
                                    time.perf_counter() - t0)

    def _pilot_postlude(self, outcome: "PilotOutcome", pilot: PilotStats,
                        theta_p: float, elapsed_s: float) -> "PilotOutcome":
        """Fill the report from one pilot stage's statistics and apply the
        too-small / no-groups fallbacks."""
        report = outcome.report
        report.pilot_time_s = elapsed_s
        report.theta_pilot = theta_p
        report.n_pilot_blocks = pilot.n_sampled_blocks
        report.pilot_scanned_bytes = pilot.scanned_bytes
        report.pilot_ran = True
        outcome.pilot = pilot
        outcome.theta_p = theta_p
        if pilot.n_sampled_blocks < 2:
            outcome.fallback = "pilot sample too small"
            return outcome
        if len(np.nonzero(pilot.group_present)[0]) == 0:
            outcome.fallback = "no groups in pilot"
        return outcome

    def run_pilots_batched(self, reqs: List[Tuple[Query, ErrorSpec, int]]
                           ) -> List[object]:
        """Stage 1 for many pilot subgroups at once.

        ``reqs`` holds one ``(query, spec, pilot_seed)`` per subgroup
        leader; the returned list is position-aligned and each entry is the
        :class:`PilotOutcome` :meth:`run_pilot` would have produced, or the
        exception it would have raised (captured per member, so one failing
        subgroup cannot sink its siblings).  Every member runs its solo
        pilot: the reference stacks same-shape gather-route pilots into one
        ``lax.map`` dispatch, but here a stacked lane would run the same
        launches as the solo pilot, so stacking would save only host syncs.
        So the reference's gates that send a staged or sharded pilot table
        to the solo loop hold here by construction: its solo pilot pins the
        ladder's seed and serves a covering rung
        (:meth:`Executor.execute_pilot`), or fans out over the shards
        (:meth:`repro_torch.dist.DistExecutor.execute_pilot`).
        """
        results: List[object] = []
        for q, spec, pseed in reqs:
            try:
                outcome, theta_p = self._pilot_prelude(q, spec)
                if outcome.fallback is None:
                    outcome = self._pilot_scan(outcome, spec, theta_p, pseed)
                results.append(outcome)
            except Exception as e:  # noqa: BLE001 — per-member capture
                results.append(e)
        return results

    def finish_from_pilot(self, q: Query, spec: ErrorSpec,
                          outcome: "PilotOutcome", seed: int,
                          shared: bool = False) -> ApproxAnswer:
        """Stage 2 for one query, from a (possibly shared) pilot outcome.

        Builds this query's own probabilistic constraints from ``spec``,
        solves the sampling-plan optimization, and runs the final query with
        this query's ``seed`` — so two queries finishing from the same pilot
        still draw their final samples independently.  ``shared=True`` marks
        the report as having reused another query's pilot stage.

        This is ``prepare_final`` + ``run_final``; the runtime calls the two
        halves separately so same-bucket finals batch into one dispatch.
        """
        return self.run_final(self.prepare_final(q, spec, outcome, seed,
                                                 shared=shared))

    def prepare_final(self, q: Query, spec: ErrorSpec,
                      outcome: "PilotOutcome", seed: int,
                      shared: bool = False) -> FinalStage:
        """The planning half of stage 2: constraints, plan optimization, and
        the final-plan rewrite — everything except the final scan itself."""
        plan, comp_channels = outcome.plan, outcome.comp_channels
        # per-query copy: members finishing from one shared outcome must not
        # see each other's plan/final timings or fallback reasons
        report = dataclasses.replace(outcome.report)
        report.pilot_shared = shared
        stage = FinalStage(q=q, spec=spec, plan=plan,
                           comp_channels=comp_channels, report=report)
        if outcome.fallback is not None:
            stage.answer = self._exact(q, plan, comp_channels, report,
                                       outcome.fallback)
            return stage
        pilot = outcome.pilot
        pilot_table = outcome.pilot_table
        pair_tables = outcome.pair_tables
        theta_p = outcome.theta_p

        # --- budgets & constraints -------------------------------------------
        t0 = time.perf_counter()
        present = np.nonzero(pilot.group_present)[0]

        channel_budgets: List[Tuple[int, ChannelBudget]] = []
        n_constraints = 0
        for comp, idxs in zip(q.aggs, comp_channels):
            n_constraints += len(idxs) * len(present)
        report.num_channels = n_constraints

        constraints: List[Constraint] = []
        infeasible_reason = None
        for comp, idxs in zip(q.aggs, comp_channels):
            e_part = propagation.split_budget(comp.kind, spec.error)
            for ch in idxs:
                budget = allocate(spec.confidence, n_constraints, e_part)
                for g in present:
                    y = pilot.block_sums[:, g, ch]
                    # L_μ of the population total: N · (block-mean lower bound)
                    L_mu = pilot.n_total_blocks * bsap.block_mean_lower(y, budget.delta1)
                    if not np.isfinite(L_mu) or L_mu <= 0.0:
                        infeasible_reason = (
                            f"non-positive aggregate lower bound (agg={comp.name}, group={g})")
                        break
                    z = bsap.z_for(budget.p_prime)
                    var_fn = self._make_var_fn(pilot, pilot_table, pair_tables,
                                               ch, g, theta_p, budget.delta2)
                    constraints.append(Constraint(
                        label=f"{comp.name}[g{g}]ch{ch}", z=z, L_mu=L_mu,
                        error=budget.error, var_fn=var_fn))
                if infeasible_reason:
                    break
            if infeasible_reason:
                break
        if infeasible_reason:
            report.plan_time_s = time.perf_counter() - t0
            stage.answer = self._exact(q, plan, comp_channels, report,
                                       infeasible_reason)
            return stage

        # --- Stage 2: plan optimization ----------------------------------------
        sampleable = [pilot_table] + [t for t in pair_tables]
        candidates = solve_candidates(constraints, sampleable,
                                      max_rate=spec.max_final_rate)
        report.candidates = len(candidates)
        chosen = pick_plan(
            candidates,
            cost_fn=lambda rates: cost_mod.plan_cost(plan, self.ex.catalog, rates),
            exact_cost=report.exact_cost,
        )
        report.plan_time_s = time.perf_counter() - t0
        if chosen is None:
            stage.answer = self._exact(q, plan, comp_channels, report,
                                       "no feasible plan cheaper than exact")
            return stage
        report.plan = chosen

        # --- final-plan rewrite (execution is run_final's / the batch's) ------
        samples = {t: L.SampleClause("block", r, seed + 977)
                   for t, r in chosen.rates.items() if r < 1.0}
        stage.final_plan = L.rewrite_scans(plan, samples)
        return stage

    def run_final(self, stage: FinalStage) -> ApproxAnswer:
        """The execution half of stage 2 for one query, solo."""
        if stage.answer is not None:
            return stage.answer
        t0 = time.perf_counter()
        try:
            res = self.ex.execute(stage.final_plan)
        except EmptySampleError as e:
            # The planner's rate drew zero blocks — no unbiased upscale
            # exists, so PilotDB's "never return an unguaranteed estimate"
            # contract forces the exact path (explicitly, not via a
            # fabricated scale).
            stage.report.final_time_s = time.perf_counter() - t0
            return self._exact(stage.q, stage.plan, stage.comp_channels,
                               stage.report, f"final sample empty ({e.table})")
        return self._finish_result(stage, res, time.perf_counter() - t0)

    def run_finals_batched(self, stages: List[FinalStage],
                           on_answer: Optional[Callable] = None) -> None:
        """Execute many prepared finals, one batched kernel launch per
        same-signature bucket (:meth:`Executor.execute_batch`), filling each
        stage's ``answer``.

        Lane k of a launch computes member k's solo per-block stats and
        reduces them as the solo route does, so answers are bitwise those
        of :meth:`run_final`; a member whose sampled scan comes back empty
        takes its own exact fallback, as it would solo.  ``on_answer(stage)``
        runs the moment a stage's answer is filled (per bucket), and each
        member's ``final_time_s`` is the time until its bucket completed.
        A failing batched launch raises to the caller.
        """
        pend = [s for s in stages if s.answer is None]
        if not pend:
            return
        t0 = time.perf_counter()

        def land(i: int, res) -> None:
            stage = pend[i]
            elapsed = time.perf_counter() - t0
            if isinstance(res, EmptySampleError):
                stage.report.final_time_s = elapsed
                stage.answer = self._exact(
                    stage.q, stage.plan, stage.comp_channels, stage.report,
                    f"final sample empty ({res.table})")
            else:
                stage.answer = self._finish_result(stage, res, elapsed)
            if on_answer is not None:
                on_answer(stage)

        self.ex.execute_batch([s.final_plan for s in pend], on_result=land)

    def _finish_result(self, stage: FinalStage, res,
                       elapsed_s: float) -> ApproxAnswer:
        stage.report.final_time_s = elapsed_s
        stage.report.final_scanned_bytes = res.scanned_bytes
        values = _combine(stage.q, stage.comp_channels, res.values)
        return ApproxAnswer([c.name for c in stage.q.aggs], values,
                            res.group_present, stage.report)

    # -- variance-bound factory ------------------------------------------------
    def _make_var_fn(self, pilot: PilotStats, pilot_table: str,
                     pair_tables: Tuple[str, ...], ch: int, g: int,
                     theta_p: float, delta2: float):
        y = pilot.block_sums[:, g, ch]
        if pair_tables and pair_tables[0] in pilot.pair_sums:
            other = pair_tables[0]
            uv2 = bsap.join_var_ub(pilot.pair_sums[other][:, :, ch],
                                   pilot.n_total_blocks, delta2)
            uv1 = bsap.single_table_var_ub(y, theta_p, delta2,
                                           n_blocks=pilot.n_total_blocks)

            def var_fn(rates: Dict[str, float]) -> float:
                t1 = rates.get(pilot_table, 1.0)
                t2 = rates.get(other, 1.0)
                if t2 >= 1.0:
                    return uv1(t1) if t1 < 1.0 else 0.0
                return uv2(t1, t2)

            return var_fn

        uv1 = bsap.single_table_var_ub(y, theta_p, delta2,
                                       n_blocks=pilot.n_total_blocks)

        def var_fn(rates: Dict[str, float]) -> float:
            t1 = rates.get(pilot_table, 1.0)
            return uv1(t1) if t1 < 1.0 else 0.0

        return var_fn

    # -- ground truth -----------------------------------------------------------
    def exact(self, q: Query) -> ApproxAnswer:
        plan, comp_channels = self._engine_plan(q)
        report = TaqaReport()
        return self._exact(q, plan, comp_channels, report, "requested exact")


def _combine(q: Query, comp_channels, channel_values: np.ndarray) -> np.ndarray:
    """Combine simple-channel estimates into composite values per group."""
    n_groups = channel_values.shape[1]
    out = np.zeros((len(q.aggs), n_groups))
    for k, (comp, idxs) in enumerate(zip(q.aggs, comp_channels)):
        if comp.num_channels == 1:
            out[k] = channel_values[idxs[0]]
        else:
            v1, v2 = channel_values[idxs[0]], channel_values[idxs[1]]
            with np.errstate(invalid="ignore", divide="ignore"):
                if comp.kind in ("avg", "ratio"):
                    out[k] = np.where(v2 != 0, v1 / np.where(v2 == 0, 1, v2), np.nan)
                elif comp.kind == "product":
                    out[k] = v1 * v2
                elif comp.kind == "add":
                    out[k] = comp.weights[0] * v1 + comp.weights[1] * v2
    return out
