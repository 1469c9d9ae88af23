"""One pilot, many finals: group execution with shared pilot statistics and
batched final launches.

A drain group holds queries with equal *template* signatures (sampling- and
constant-stripped plan — the compile-cache grouping key).  Within it, pilot
work re-splits on the FULL constant-bearing structural signature plus the
pilot-stage tunables (:func:`repro_torch.core.taqa.pilot_params`): pilot
block statistics depend on predicate selectivity, so two queries differing
in a WHERE constant never share a pilot.  Members agreeing on both run ONE
pilot and fan its block statistics out: each solves its own sampling-plan
optimization from its own ErrorSpec and draws its own final sample from its
own seed.

Stage 1.  When a group holds two or more pilot subgroups, their pilots run
through ``PilotDB.run_pilots_batched``, which stacks the pilots that share a
signature and a draw size into one call (one kernel launch per channel
column, or one ``segment_sum`` launch; one host copy) and runs the rest
solo; the subgroups' stage-2 planning then fans out on the runtime's pilot
pool and re-joins here.

Batched finals.  Every subgroup first plans its members' finals, then the
whole group's pending final scans run through ``PilotDB.run_finals_batched``:
members sharing a compile key run as ONE batched call
(``SessionConfig.batch_finals``; off, each member runs its own final).  A
failing batched call raises out of the group and fails its unfinished
members (``AsyncRuntime`` captures it); it is never re-run as solo calls.

Streaming and tracing.  The pilot's advisory estimate fans out to every
member as a :class:`repro_torch.stream.PilotFrame` the moment stage 1
returns, before any stage-2 planning; the shared pilot runs on the leader's
trace and every other member gets a summary span.  Worker threads do not
inherit context variables, so each member's trace is activated around the
work done for it and deactivated after.

Bit-identity.  The pilot seed derives from (session seed, structural
signature, pilot params) — not from any member's per-query seed — and the
session uses the *same* derivation when a query runs solo.  A query answered
from a shared pilot and/or a batched final is therefore bitwise the same
query run alone on an equal-seed session: same pilot sample, same chosen
plan, same final sample, same f32 reductions.

Failure capture.  A member whose stage 2 raises fails alone; a pilot-stage
exception fails every member that would have used that pilot (each would
have raised identically solo).
"""

from __future__ import annotations

import dataclasses
import time
from typing import TYPE_CHECKING, Dict, List, Optional, Tuple

from repro_torch.core.taqa import (FinalStage, PilotOutcome, advisory_estimate,
                                   pilot_params)
from repro_torch.obs import trace as _trace
from repro_torch.stream import pilot_frame_for

if TYPE_CHECKING:  # runtime layering: session owns the runtime
    from repro_torch.api.session import QueryHandle, Session


def subgroup_by_pilot(handles: List["QueryHandle"]) -> List[List["QueryHandle"]]:
    """Split a drain group into pilot-sharing subgroups.

    Exact-mode members (no ErrorSpec) run no pilot and each form their own
    singleton; approximate members subgroup by (full constant-bearing
    signature, pilot params).  Submission order is kept within and across
    subgroups (first-arrival order).
    """
    subgroups: Dict[Tuple, List["QueryHandle"]] = {}
    for h in handles:
        key = ("exact", h.query_id) if h.spec is None \
            else ("pilot", h.signature) + pilot_params(h.spec)
        subgroups.setdefault(key, []).append(h)
    return list(subgroups.values())


@dataclasses.dataclass
class _Pending:
    """One group member between stage-2 planning and completion."""

    handle: "QueryHandle"
    gen: tuple                              # table-generation snapshot
    outcome: PilotOutcome
    stage: Optional[FinalStage] = None      # None: deferred duplicate
    failed: Optional[str] = None
    est: Optional[object] = None            # advisory PilotEstimate (or None)


def execute_group(session: "Session", handles: List["QueryHandle"]) -> None:
    """Run one drain group: cached members answer immediately, each
    pilot-sharing subgroup runs one pilot, pending finals batch into one
    launch per bucket, members complete independently in submission order."""
    shared: List[List["QueryHandle"]] = []
    for members in subgroup_by_pilot(handles):
        live = []
        for h in members:
            if h.done:
                continue
            # per-member trace activation: the cache probe's span must land
            # on ITS handle's tree, not a neighbor's
            token = _trace.activate(h._trace)
            try:
                if not session._serve_cached(h):
                    live.append(h)
            finally:
                _trace.deactivate(token)
        if not live:
            continue
        if live[0].spec is None or not session.config.share_pilots:
            # exact members, or sharing disabled: the solo path (its own
            # pilot, its own final launch)
            for h in live:
                session._run_handle(h)
            continue
        if session.config.fused_taqa and len(live) == 1 \
                and _try_fused(session, live[0]):
            continue  # the single-launch program delivered the answer
        shared.append(live)

    # Several pilot subgroups: their pilots run first on this worker
    # (PilotDB.run_pilots_batched: same-shape pilots stacked into one call,
    # the rest one after another), with the table generations snapshotted
    # before them so the mid-flight replacement guard covers the pilot
    # stage.
    pre: List[Optional[object]] = [None] * len(shared)
    gens: List[Optional[tuple]] = [None] * len(shared)
    if len(shared) >= 2:
        for live in shared:
            for h in live:
                h._mark_running()
        gens = [session._scan_generations(live[0].query) for live in shared]
        pre = session.db.run_pilots_batched(
            [(live[0].query, live[0].spec, session._pilot_seed_for(live[0]))
             for live in shared])

    # Stage-2 planning per subgroup, fanned out on the pilot pool; results
    # come back in submission order and every seed is content-derived, so
    # concurrency changes wall-clock, never answers.
    durations: List[float] = []

    def stage1(args) -> List[_Pending]:
        live, outcome, gen = args
        t0 = time.perf_counter()
        try:
            return _pilot_and_prepare(session, live, pre=outcome, gen=gen)
        finally:
            durations.append(time.perf_counter() - t0)

    t0 = time.perf_counter()
    pend_lists = session.runtime.map_pilot_subgroups(
        stage1, list(zip(shared, pre, gens)))
    if len(shared) >= 2:
        session.runtime.record_pilot_fanout(
            time.perf_counter() - t0, sum(durations))
    subgroups = [p for p in pend_lists if p]

    # one batched launch per same-signature bucket across the WHOLE group;
    # each subgroup's pilot-ownership box is shared between the per-bucket
    # early completions and the serial sweep below, so exactly one completed
    # member per subgroup carries pilot_shared=False whichever path lands it
    boxes = [{"owns": True} for _ in subgroups]
    by_stage: Dict[int, Tuple[_Pending, dict]] = {}
    for pend, box in zip(subgroups, boxes):
        for p in pend:
            if p.stage is not None and p.failed is None \
                    and p.stage.answer is None:
                by_stage[id(p.stage)] = (p, box)
    if session.config.batch_finals and len(by_stage) >= 2:
        def on_answer(stage: FinalStage) -> None:
            # a bucket landed: complete its members now — streaming clients
            # see their FinalFrames while later buckets are still launching
            # (the serial sweep below skips done handles)
            p, box = by_stage[id(stage)]
            _complete_one(session, p, box)

        session.db.run_finals_batched(
            [pb[0].stage for pb in by_stage.values()], on_answer=on_answer)

    for pend, box in zip(subgroups, boxes):
        for p in pend:
            _complete_one(session, p, box)


def _try_fused(session: "Session", h: "QueryHandle") -> bool:
    """The single-launch fused TAQA program for a singleton subgroup.  True
    when the handle completed (answered, or failed by the program's error or
    the completion guard); False when the query's shape is outside the
    fused envelope — the caller then runs the shared-pilot path, nothing
    having executed."""
    token = _trace.activate(h._trace)
    try:
        h._mark_running()
        gen = session._scan_generations(h.query)
        try:
            ans = session._run_fused(h)
        except Exception as e:  # a failing member fails alone, as in _run_handle
            h._mark_failed(f"{type(e).__name__}: {e}")
            return True
        if ans is None:
            return False
        with _trace.span("deliver"):
            session._complete_handle(h, ans, gen)
        return True
    finally:
        _trace.deactivate(token)


def _pilot_and_prepare(session: "Session", live: List["QueryHandle"],
                       pre: Optional[object] = None,
                       gen: Optional[tuple] = None) -> List[_Pending]:
    """Run the subgroup's one pilot stage and plan every member's final.

    ``pre`` is a pilot already run by ``PilotDB.run_pilots_batched``: a
    :class:`PilotOutcome` skips the pilot here, a captured exception fails
    every member, and None runs the pilot now.  ``gen`` is the
    table-generation snapshot taken before that pilot.
    """
    leader = live[0]
    if gen is None:
        gen = session._scan_generations(leader.query)
    for h in live:
        h._mark_running()
    shared = len(live) > 1
    if isinstance(pre, Exception):
        # every member's solo pilot would have raised identically
        for h in live:
            h._mark_failed(f"{type(pre).__name__}: {pre}")
        return []
    if pre is not None:
        outcome = pre
        rep = outcome.report
        if leader._trace is not None:
            leader._trace.record(
                "pilot", duration_s=rep.pilot_time_s, shared=shared,
                owner=True, members=len(live), batched=True,
                table=rep.pilot_table, theta_pilot=rep.theta_pilot,
                n_pilot_blocks=rep.n_pilot_blocks,
                scanned_bytes=rep.pilot_scanned_bytes,
                fallback=rep.fallback)
    else:
        # the shared pilot runs ONCE, on the leader's trace: deep tags
        # (staged rung, shard fan-out, compile hit/miss) annotate the
        # leader's open "pilot" span; members get a summary span below
        token = _trace.activate(leader._trace)
        try:
            with _trace.span("pilot", shared=shared, owner=True,
                             members=len(live)) as sp:
                outcome = session.db.run_pilot(leader.query, leader.spec,
                                               session._pilot_seed_for(leader))
                rep = outcome.report
                sp.set(table=rep.pilot_table, theta_pilot=rep.theta_pilot,
                       n_pilot_blocks=rep.n_pilot_blocks,
                       scanned_bytes=rep.pilot_scanned_bytes,
                       fallback=rep.fallback)
        except Exception as e:
            # every member's solo pilot would have raised identically
            for h in live:
                h._mark_failed(f"{type(e).__name__}: {e}")
            return []
        finally:
            _trace.deactivate(token)
    # one flight-recorder record per pilot STAGE (not per member): the
    # leader's qid plus the member count it fanned out to
    session._emit_event("pilot", qid=leader.query_id, shared=shared,
                        members=len(live), table=rep.pilot_table,
                        scanned_bytes=rep.pilot_scanned_bytes,
                        wall_s=round(rep.pilot_time_s, 6),
                        fallback=rep.fallback)
    for h in live[1:]:
        if h._trace is not None:
            h._trace.record(
                "pilot", duration_s=rep.pilot_time_s, shared=True,
                owner=False, table=rep.pilot_table,
                theta_pilot=rep.theta_pilot,
                n_pilot_blocks=rep.n_pilot_blocks,
                scanned_bytes=rep.pilot_scanned_bytes,
                fallback=rep.fallback)
    # fan the pilot's advisory estimate out to EVERY member the moment
    # stage 1 returns, before any stage-2 planning or launch.  Members share
    # pilot statistics but not necessarily confidence, so the t-interval is
    # computed per distinct confidence level.  The estimate is host numpy
    # over block sums already on the host; the result cache records it.
    ests: Dict[float, Optional[object]] = {}
    for h in live:
        conf = h.spec.confidence
        if conf not in ests:
            ests[conf] = advisory_estimate(h.query, outcome, conf)
        if ests[conf] is not None:
            h._emit(pilot_frame_for(h.query_id, ests[conf], shared=shared))
    pend: List[_Pending] = []
    seen_keys = set()
    for h in live:
        token = _trace.activate(h._trace)
        try:
            # an earlier drain's completion may have cached this member's
            # exact (query, spec, seed) answer
            if session._serve_cached(h):
                continue
            p = _Pending(handle=h, gen=gen, outcome=outcome,
                         est=ests.get(h.spec.confidence))
            key = session._cache_key(h)
            if session.result_cache.enabled and key in seen_keys:
                # identical re-issue inside one drain: the earlier member's
                # completion caches the answer — defer instead of paying a
                # duplicate final
                pend.append(p)
                continue
            seen_keys.add(key)
            try:
                with _trace.span("rate_solve") as sp:
                    p.stage = session.db.prepare_final(h.query, h.spec,
                                                       outcome, seed=h.seed)
                    srep = p.stage.report
                    sp.set(candidates=srep.candidates,
                           fallback=srep.fallback,
                           rates=dict(srep.plan.rates)
                           if srep.plan is not None else None)
                session._emit_event("rate_solve", qid=h.query_id,
                                    candidates=srep.candidates,
                                    fallback=srep.fallback)
            except Exception as e:  # a failing member must not sink peers
                p.failed = f"{type(e).__name__}: {e}"
            pend.append(p)
        finally:
            _trace.deactivate(token)
    return pend


def _complete_one(session: "Session", p: _Pending, box: dict) -> None:
    """Finish ONE member (idempotent): called early by the batched launch's
    per-bucket callback, and again by the subgroup's serial sweep — whoever
    runs first delivers; the other sees ``handle.done`` and returns.

    ``box["owns"]`` is the subgroup's pilot-ownership flag: the first member
    that COMPUTES (not cache-serves) a completed answer owns the pilot stage
    in its report (pilot_shared=False); drain stats count pilot stages by
    that flag.  Both callers run on the group's worker thread, so the box
    needs no lock.
    """
    h = p.handle
    if h.done:
        return
    token = _trace.activate(h._trace)
    try:
        if p.failed is not None:
            h._mark_failed(p.failed)
            return
        # a peer's completion may have cached this member's answer already
        if session._serve_cached(h):
            return
        try:
            if p.stage is None:  # deferred duplicate whose peer failed
                with _trace.span("rate_solve", deferred=True):
                    p.stage = session.db.prepare_final(h.query, h.spec,
                                                       p.outcome, seed=h.seed)
            # a stage answered before this sweep: the batched launch landed
            # it (or the rate solve fell back to exact) — run_final just
            # returns it
            pre_answered = p.stage.answer is not None
            with _trace.span("final") as sp:
                ans = session.db.run_final(p.stage)
                batched = pre_answered and ans.report.fallback is None
                sp.set(batched=batched,
                       scanned_bytes=ans.report.final_scanned_bytes,
                       fallback=ans.report.fallback)
            session._emit_event(
                "final", qid=h.query_id, batched=batched,
                scanned_bytes=ans.report.final_scanned_bytes,
                wall_s=round(ans.report.final_time_s, 6),
                fallback=ans.report.fallback)
            ans.report.pilot_shared = not box["owns"]
            # ownership sticks only to a COMPLETED answer: if completion
            # fails (mid-flight table replacement), the next member carries
            # the non-shared report
            with _trace.span("deliver"):
                if session._complete_handle(h, ans, p.gen, pilot_est=p.est):
                    box["owns"] = False
        except Exception as e:  # a member failing alone must not sink peers
            h._mark_failed(f"{type(e).__name__}: {e}")
    finally:
        _trace.deactivate(token)
