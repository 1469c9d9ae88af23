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
:meth:`PilotDB.run_pilots_batched`, which stacks same-shape pilots into one
call.
:meth:`PilotDB.run_fused` runs both stages as one program on the device
(the pilot, an f32 rate solve and the final draw on the card, then the
final), bitwise the two-stage answer.  :func:`advisory_estimate` turns a pilot
outcome into the provisional estimate a streaming client sees before the
guaranteed answer (host f64 over the pilot's block sums, as in the
reference).
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
from repro_torch.engine.executor import (EmptySampleError, Executor, PilotStats,
                                         QueryResult)
from repro_torch.engine.physical import ScanRuntime
from repro_torch.engine.sampling import draw_block_ids, pad_block_ids
from repro_torch.stats import chi2_ppf, normal_ppf, student_t_ppf


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


@dataclasses.dataclass(frozen=True)
class PilotEstimate:
    """An ADVISORY pilot-stage estimate of every user-facing aggregate.

    This is what progressive streaming shows while the guarantee converges
    (:mod:`repro_torch.stream`) and what the result cache records so cached
    re-issues can replay a provisional frame: Hájek point estimates per
    group plus provisional CI half-widths — compact (two
    ``(num_aggs, max_groups)`` arrays), never the per-block matrix.

    The interval is the pilot sample's t-interval propagated through the
    Table-2 composite rules (:mod:`repro_torch.core.propagation`); it carries NO
    a-priori guarantee — only the final answer's §4 report does.
    """

    names: Tuple[str, ...]
    values: np.ndarray          # (num_aggs, max_groups) float64
    half_widths: np.ndarray     # absolute CI half-widths, same shape
    group_present: np.ndarray   # (max_groups,) bool — groups seen by the pilot
    confidence: float
    theta_pilot: float
    n_pilot_blocks: int

    def nbytes(self) -> int:
        """Byte footprint for result-cache accounting."""
        return (self.values.nbytes + self.half_widths.nbytes
                + self.group_present.nbytes
                + sum(len(n) for n in self.names))

    def scalar(self, name: str, group: int = 0) -> float:
        return float(self.values[self.names.index(name), group])

    def half_width(self, name: str, group: int = 0) -> float:
        return float(self.half_widths[self.names.index(name), group])


def advisory_estimate(q: Query, outcome: "PilotOutcome",
                      confidence: float) -> Optional[PilotEstimate]:
    """Construct the advisory estimate a pilot outcome already paid for.

    Point estimates are the Hájek totals ``N·ȳ_p`` per simple channel,
    combined into composites by the same rules as the final answer
    (:func:`_combine`).  Half-widths are two-sided t-intervals on each
    channel total, propagated to composites through the Table-2 relative-
    error rules (:mod:`repro_torch.core.propagation`): division/avg
    ``(e1+e2)/(1−max)``, product ``e1+e2+e1·e2``, addition ``max(e1,e2)``
    — ``inf`` wherever a channel cannot be bounded (zero estimate, or a
    propagated relative error ≥ 1).

    Returns None when no advisory estimate exists: the pilot never ran,
    sampled fewer than 2 blocks, or stage 1 already decided on the exact
    fallback (the terminal frame will be exact — a provisional estimate
    would only mislead).
    """
    pilot = outcome.pilot
    if pilot is None or outcome.fallback is not None:
        return None
    bs = np.asarray(pilot.block_sums, dtype=np.float64)
    n_p = bs.shape[0]
    if n_p < 2:
        return None
    N = float(pilot.n_total_blocks)
    # channel totals and t-interval half-widths: (channels, max_groups)
    ch_vals = (N * bs.mean(axis=0)).T
    delta = min(max((1.0 - confidence) / 2.0, 1e-12), 0.5)
    t_q = student_t_ppf(1.0 - delta, n_p - 1)
    ch_hw = (N * t_q / np.sqrt(n_p) * bs.std(axis=0, ddof=1)).T
    values = _combine(q, outcome.comp_channels, ch_vals)
    with np.errstate(divide="ignore", invalid="ignore"):
        rel = np.where(ch_vals != 0.0,
                       np.abs(ch_hw / np.where(ch_vals == 0.0, 1.0, ch_vals)),
                       np.inf)
        half = np.full_like(values, np.inf)
        for k, (comp, idxs) in enumerate(zip(q.aggs, outcome.comp_channels)):
            if comp.num_channels == 1:
                half[k] = np.abs(ch_hw[idxs[0]])
                continue
            e1, e2 = rel[idxs[0]], rel[idxs[1]]
            if comp.kind in ("avg", "ratio"):
                m = np.maximum(e1, e2)
                e = np.where(m < 1.0, (e1 + e2) / np.maximum(1.0 - m, 1e-300),
                             np.inf)
            elif comp.kind == "product":
                e = e1 + e2 + e1 * e2
            else:  # "add"
                e = np.maximum(e1, e2)
            half[k] = e * np.abs(values[k])
    return PilotEstimate(
        names=tuple(c.name for c in q.aggs), values=values, half_widths=half,
        group_present=np.asarray(pilot.group_present, dtype=bool),
        confidence=float(confidence), theta_pilot=float(outcome.theta_p),
        n_pilot_blocks=int(pilot.n_sampled_blocks))


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
        """Stage 1 for many pilot subgroups at once, stacking same-shape
        pilot scans into one call (:meth:`Executor.execute_pilots_batched`).

        ``reqs`` holds one ``(query, spec, pilot_seed)`` per subgroup
        leader; the returned list is position-aligned and each entry is the
        :class:`PilotOutcome` :meth:`run_pilot` would have produced, or the
        exception it would have raised (captured per member, so one failing
        subgroup cannot sink its siblings).

        Undershoot retries are a host computation, so each member's draw is
        resolved here with the solo loop's seeds and x4 bumps, and members
        agreeing on (pilot table, query signature) stack: one call, one
        device->host copy, lane k bitwise member k's solo pilot.  The
        prelude's fallbacks, the eager executor, pair tables, a staged
        ladder on the pilot table (its solo pilot pins the ladder's seed and
        serves a rung), a sharded pilot table (its solo pilot fans out over
        the shards), a plan whose pilots do not stack
        (:meth:`PhysicalCompiler.pilot_stacks`), an empty draw and a group
        of one run the solo loop.  Unlike the reference, which stacks its
        XLA route only, the kernel route stacks too; and a failing stacked
        call fails each of its members with its exception, where the
        reference re-runs them solo: on the card a re-run would hide a
        failed kernel.
        """
        ex = self.ex
        results: List[object] = [None] * len(reqs)
        prel: List[Optional[Tuple[PilotOutcome, float]]] = [None] * len(reqs)
        solo: List[int] = []
        groups: Dict[tuple, List[tuple]] = {}
        for i, (q, spec, pseed) in enumerate(reqs):
            try:
                outcome, theta_p = self._pilot_prelude(q, spec)
            except Exception as e:  # noqa: BLE001 — per-member capture
                results[i] = e
                continue
            prel[i] = (outcome, theta_p)
            if outcome.fallback is not None:
                results[i] = outcome
                continue
            pt = outcome.pilot_table
            if (not ex.use_compiled or outcome.pair_tables
                    or ex.staged.ladder(pt) is not None or ex.is_sharded(pt)
                    or not ex.physical.pilot_stacks(outcome.plan, pt)):
                solo.append(i)
                continue
            # the solo loop's draws, retries included: drawn at th, then
            # bumped x4 while short of the minimum
            n_blocks = ex.table_blocks(pt)
            need = min(spec.min_pilot_blocks, n_blocks)
            th = drawn_th = theta_p
            for attempt in range(3):
                ids = draw_block_ids(n_blocks, th, pseed + 101 * attempt)
                drawn_th = th
                if len(ids) >= need:
                    break
                th = min(th * 4.0, 1.0)
            if len(ids) == 0:
                solo.append(i)  # the solo path owns the empty draw's stats
                continue
            phys, n_real, n_phys = pad_block_ids(ids, n_blocks)
            runtime = ScanRuntime("block", n_real, n_phys, phys)
            key = ex.physical.query_signature(outcome.plan, {pt: runtime})
            groups.setdefault((pt, key), []).append((i, runtime, th, drawn_th))

        for (pt, _), members in groups.items():
            if len(members) < 2:
                solo.extend(m[0] for m in members)
                continue
            idxs = [m[0] for m in members]
            for _ in idxs:  # one pilot stage per member
                ex._count("pilots_run")
            try:
                stats = ex.execute_pilots_batched(
                    [prel[i][0].plan for i in idxs], pt,
                    [m[3] for m in members], [{pt: m[1]} for m in members])
            except Exception as e:  # noqa: BLE001 — per-member capture
                for i in idxs:
                    results[i] = e
                continue
            # the postlude takes the bumped rate, PilotStats the drawn one,
            # as on the solo loop
            for (i, _, th, _), st in zip(members, stats):
                results[i] = self._pilot_postlude(prel[i][0], st, th,
                                                  st.wall_time_s)

        for i in solo:
            _, spec, pseed = reqs[i]
            outcome, theta_p = prel[i]
            try:
                results[i] = self._pilot_scan(outcome, spec, theta_p, pseed)
            except Exception as e:  # noqa: BLE001 — per-member capture
                results[i] = e
        return results

    def run_fused(self, q: Query, spec: ErrorSpec, seed: int = 0,
                  pilot_seed: Optional[int] = None) -> Optional[ApproxAnswer]:
        """Single-launch TAQA: the pilot scan, the BSAP rate solve and the
        final sampled aggregation as ONE program on the device
        (:meth:`PhysicalCompiler.compile_fused`).

        Returns None when the query is outside the fused envelope — the
        eager executor, grouped queries, join-pair sampling, a sharded
        pilot table, no large table, or a pilot draw too small to bound —
        before any device work; the caller then runs the two-stage path,
        which is the semantic and bitwise oracle.  Unlike the reference,
        which does not fuse on its Pallas kernel route, every route fuses
        here: on the card the column kernels are the route.

        Bit-identity is by construction: the device solve is an ADVISORY
        f32 twin; the pilot block statistics come from the solo pilot body
        and feed the SAME f64 ``prepare_final`` as the two-stage path, and
        the device's final block draw is verified against the host draw
        (the same content-derived uniforms) before its sums are trusted.
        Any disagreement — f32 rounding of the solved rate flipping a
        Bernoulli comparison — discards the fused final sums and runs
        stage 2 solo.
        """
        ex = self.ex
        if not ex.use_compiled:
            return None
        if q.group_by is not None or q.max_groups != 1:
            return None
        outcome, theta_p = self._pilot_prelude(q, spec)
        if outcome.fallback is not None or outcome.pair_tables:
            return None
        pilot_table = outcome.pilot_table
        if ex.is_sharded(pilot_table):
            return None
        plan, report = outcome.plan, outcome.report
        psd = seed if pilot_seed is None else pilot_seed
        n_blocks = ex.table_blocks(pilot_table)

        # The host pilot draw with its undershoot retries: draw sizes are
        # host RNG alone, so the retries cost no launch.  Seeds, the x4 bump
        # (applied even past a failed last attempt) and the staged-seed
        # pinning replay the two-stage loop exactly.
        need = min(spec.min_pilot_blocks, n_blocks)
        ids = np.zeros(0, np.int32)
        theta_drawn = theta_p
        for attempt in range(3):
            eff = ex.staged.seed_for(pilot_table, psd + 101 * attempt)
            ids = draw_block_ids(n_blocks, theta_p, eff)
            theta_drawn = theta_p
            if len(ids) >= need:
                break
            theta_p = min(theta_p * 4.0, 1.0)
        if len(ids) < 2:
            return None  # two-stage takes its "pilot sample too small" path

        phys, n_real, n_phys = pad_block_ids(ids, n_blocks)
        runtimes = {pilot_table: ScanRuntime("block", n_real, n_phys, phys)}
        for s in plan.scans():
            if s.table != pilot_table:
                runtimes.setdefault(s.table, ScanRuntime("none"))

        # Per-channel quantile rows for the device solve: the constants
        # prepare_final's f64 solve uses (one group, g = 0).
        n_constraints = sum(len(idxs) for idxs in outcome.comp_channels)
        solve_rows: List[List[float]] = []
        solve_channels: List[int] = []
        for comp, idxs in zip(q.aggs, outcome.comp_channels):
            e_part = propagation.split_budget(comp.kind, spec.error)
            for ch in idxs:
                budget = allocate(spec.confidence, n_constraints, e_part)
                solve_rows.append([
                    student_t_ppf(1.0 - budget.delta1, n_real - 1),
                    chi2_ppf(budget.delta2 / 2.0, n_real - 1),
                    bsap.z_for(budget.p_prime),
                    normal_ppf(1.0 - budget.delta2 / 2.0),
                    budget.error,
                ])
                solve_channels.append(ch)

        # plan_cost is linear in the one table's rate: two probes give the
        # device its cost line
        cost_b = cost_mod.plan_cost(plan, ex.catalog, {pilot_table: 0.0})
        cost_a = cost_mod.plan_cost(plan, ex.catalog, {pilot_table: 1.0}) - cost_b
        scal = [float(n_blocks), float(spec.max_final_rate), 1e-6,
                cost_a, cost_b, report.exact_cost]
        fseed = ex.staged.seed_for(pilot_table, seed + 977)
        u = np.random.default_rng(fseed).random(n_blocks)

        ex._count("pilots_run")
        t0 = time.perf_counter()
        out, compiled = ex.execute_fused(
            plan, pilot_table, runtimes, np.asarray(solve_rows, np.float64),
            np.asarray(scal, np.float64), u, tuple(solve_channels))
        launch_wall = time.perf_counter() - t0

        names = [a.name for a in plan.aggs] + ["__rows"]
        pilot = PilotStats(
            table=pilot_table, theta_p=theta_drawn, n_sampled_blocks=n_real,
            n_total_blocks=n_blocks, block_rows=ex.block_rows(pilot_table),
            agg_names=names, block_sums=out["block_sums"][:n_real],
            group_present=out["present"], pair_sums={},
            right_total_blocks={},
            scanned_bytes=compiled.scanned_bytes(runtimes),
            wall_time_s=launch_wall)
        self._pilot_postlude(outcome, pilot, theta_p, launch_wall)

        # the authoritative f64 re-solve: stage 2's own code, fed the same
        # pilot statistics as the two-stage path
        stage = self.prepare_final(q, spec, outcome, seed)
        if stage.answer is not None:
            # an exact fallback (no groups, infeasible bounds, plan costlier
            # than exact): prepare_final ran it, as on the two-stage path;
            # the fused final sums are discarded
            return stage.answer
        rate = stage.report.plan.rates.get(pilot_table, 1.0)
        host_ids = (draw_block_ids(n_blocks, rate, fseed) if rate < 1.0
                    else np.zeros(0, np.int32))
        nsel = out["nsel"]
        if (rate >= 1.0 or nsel < 1 or len(host_ids) != nsel
                or not np.array_equal(out["padded"], host_ids)):
            # the device draw disagrees with the f64 plan (or the final is
            # unsampled): stage 2 runs solo, bitwise, one more launch
            return self.run_final(stage)

        # The device's final draw IS the host draw: compose the answer from
        # the fused program's sums as the solo final would.
        t1 = time.perf_counter()
        ex._count("queries_run")
        runtimes_f, infos = ex._scan_runtimes(stage.final_plan)
        sums, counts = out["sums"], out["counts"]
        values = Executor._compose_values(stage.final_plan, sums, counts,
                                          Executor._upscale(infos))
        res = QueryResult(
            agg_names=[a.name for a in stage.final_plan.aggs],
            values=values, raw_sums=sums, group_counts=counts,
            group_present=counts > 0,
            scanned_bytes=compiled.scanned_bytes(runtimes_f),
            sample_infos=infos, wall_time_s=launch_wall)
        return self._finish_result(stage, res, time.perf_counter() - t1)

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
