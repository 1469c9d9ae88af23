"""Typed answer frames — the progressive-streaming wire format.

Every streamed query is a *monotone* sequence of frames: zero or more
advisory frames followed by exactly one terminal frame.

* :class:`PilotFrame` — the pilot-stage point estimate with a *provisional*
  confidence interval, emitted the moment TAQA's stage 1 returns (before any
  stage-2 dispatch).  ADVISORY ONLY: its CI comes from the pilot sample's
  t-statistics plus the Table-2 propagation rules, not from the §4 BSAP
  machinery — it carries no a-priori guarantee and is flagged
  ``advisory=True`` so no client can mistake it for one.
* :class:`FinalFrame` — the guaranteed TAQA answer, carrying the §4 error
  report.  BITWISE identical to the non-streaming ``handle.answer`` for the
  same query on an equal-seed session (it IS the delivered answer object,
  post-HAVING/LIMIT), for every configuration: solo, shared-pilot herd,
  batched finals, cached re-issues, staged ladders, and every shard count.
* :class:`ExactFrame` — the :class:`FinalFrame` subtype delivered when TAQA
  fell back to exact execution (``report.fallback`` set) or exact execution
  was requested; the answer is exact, hence trivially guaranteed.
* :class:`ErrorFrame` — terminal failure: execution failures are captured as
  a frame, never raised through a streaming client (mirroring
  ``QueryHandle``'s failure-capture contract).

``seq``, ``t_emit`` and ``emitted_at`` are assigned by the
:class:`repro_torch.stream.FrameBuffer` at emission (monotone per query); frames
are immutable by convention after that point.
"""

from __future__ import annotations

import dataclasses
from typing import ClassVar, Optional, Tuple

import numpy as np


@dataclasses.dataclass
class Frame:
    """Common frame header; ``seq``/``t_emit`` are buffer-assigned."""

    query_id: int = -1
    seq: int = -1                 # 0-based emission index within the stream
    t_emit: float = 0.0           # time.perf_counter() at emission
    # seconds since the query was SUBMITTED (the buffer's t0, which handles
    # pin to QueryHandle.t_submit): a client-computable latency stamp —
    # TTFF is the first frame's emitted_at, time-to-final the terminal
    # frame's — monotone in seq by construction (one emission clock)
    emitted_at: float = 0.0

    advisory: ClassVar[bool] = False
    terminal: ClassVar[bool] = False
    kind: ClassVar[str] = "frame"


@dataclasses.dataclass
class PilotFrame(Frame):
    """Pilot-stage advisory estimate (see :func:`repro_torch.core.taqa.advisory_estimate`).

    ``values``/``half_widths`` are ``(num_aggs, max_groups)`` float64: the
    Hájek point estimate of every user-facing aggregate per group, and the
    absolute half-width of its provisional ``confidence``-level interval
    (``inf`` where the pilot cannot bound a channel, e.g. zero estimates).
    ``shared=True`` marks an estimate fanned out from a pilot stage shared
    with other herd members; ``from_cache=True`` marks a replay of the
    compact pilot summary recorded on a cached answer.
    """

    names: Tuple[str, ...] = ()
    values: Optional[np.ndarray] = None        # (num_aggs, max_groups)
    half_widths: Optional[np.ndarray] = None   # absolute, same shape
    group_present: Optional[np.ndarray] = None  # (max_groups,) bool
    confidence: float = 0.0
    theta_pilot: float = 0.0
    n_pilot_blocks: int = 0
    shared: bool = False
    from_cache: bool = False

    advisory: ClassVar[bool] = True
    terminal: ClassVar[bool] = False
    kind: ClassVar[str] = "pilot"

    def scalar(self, name: str, group: int = 0) -> float:
        return float(self.values[self.names.index(name), group])

    def half_width(self, name: str, group: int = 0) -> float:
        return float(self.half_widths[self.names.index(name), group])


@dataclasses.dataclass
class FinalFrame(Frame):
    """The guaranteed answer: ``answer`` is the very object the handle
    delivers (``handle.answer``), §4 error report included — bitwise
    identity with the non-streaming path holds by construction."""

    answer: Optional[object] = None    # repro_torch.core.taqa.ApproxAnswer
    cached: bool = False               # served from the session result cache

    advisory: ClassVar[bool] = False
    terminal: ClassVar[bool] = True
    kind: ClassVar[str] = "final"

    @property
    def report(self):
        return self.answer.report if self.answer is not None else None

    def scalar(self, name: str, group: int = 0) -> float:
        return self.answer.scalar(name, group)


@dataclasses.dataclass
class ExactFrame(FinalFrame):
    """Terminal frame whose answer came from exact execution (TAQA fallback
    or requested exact) — same payload as :class:`FinalFrame`, distinct type
    so clients can tell the guarantee's provenance at a glance."""

    kind: ClassVar[str] = "exact"


@dataclasses.dataclass
class ErrorFrame(Frame):
    """Terminal failure frame: the captured execution error, never raised."""

    error: str = ""

    advisory: ClassVar[bool] = False
    terminal: ClassVar[bool] = True
    kind: ClassVar[str] = "error"


def final_frame_for(query_id: int, answer, cached: bool = False) -> FinalFrame:
    """The terminal frame for a delivered answer: :class:`ExactFrame` when
    the report records a fallback (or exact was requested), else
    :class:`FinalFrame`."""
    report = getattr(answer, "report", None)
    cls = ExactFrame if (report is not None
                         and report.fallback is not None) else FinalFrame
    return cls(query_id=query_id, answer=answer, cached=cached)


def pilot_frame_for(query_id: int, est, *, shared: bool = False,
                    from_cache: bool = False) -> PilotFrame:
    """Wrap a :class:`repro_torch.core.taqa.PilotEstimate` into a frame."""
    return PilotFrame(query_id=query_id, names=tuple(est.names),
                      values=est.values, half_widths=est.half_widths,
                      group_present=est.group_present,
                      confidence=est.confidence,
                      theta_pilot=est.theta_pilot,
                      n_pilot_blocks=est.n_pilot_blocks,
                      shared=shared, from_cache=from_cache)
