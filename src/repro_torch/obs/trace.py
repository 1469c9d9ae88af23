"""Query-lifecycle tracing: one span tree per :class:`QueryHandle`.

A :class:`QueryTrace` records the full life of a query as nested timed
spans — parse → lower → schedule → pilot (shared/solo, staged-rung,
shard-fanout tags) → advisory → rate solve (§4: bounds, solve, pick) →
final dispatch (batched/solo/staged/per-shard) → deliver — with wall times,
``scanned_bytes`` and fallback reasons as span attributes.  Below the stages
each scan shows its host block ``draw``, the ``dispatch`` of its compiled
callable (compile-cache hits and misses as attributes, a ``compile`` span on
a miss) and every ``host_read``: each wait of the host on the device.  A
drain group's shared stage-1 pilots and batched finals are ``group_pilots``
and ``group_finals`` (:func:`group_span`).  Exportable as a JSON span tree
(:meth:`QueryTrace.to_dict`) or Chrome trace-event format
(:meth:`QueryTrace.to_chrome`, load in ``chrome://tracing`` / Perfetto) via
``handle.trace()`` / ``handle.trace("chrome")``.

Zero-overhead contract.  Tracing is opt-in (``SessionConfig.tracing``,
default False): an untraced handle carries no trace object, nothing is
activated, and every instrumentation point in the engine degrades to a
single context-var read returning the shared no-op span — the default path
is behaviorally identical to the pre-tracing code.  With tracing ON, spans
only *observe* (``time.perf_counter`` + attribute dicts); they never touch
seed derivation, sampling, plan choice, or reduction order — so traced
answers are bit-identical to untraced ones in every configuration (the
``tests/test_obs.py`` matrix pins solo/herd/batched/cached/staged/sharded).
Every time is ``time.perf_counter``, the clock a device trace can be tied
to; :meth:`QueryTrace.to_dict` gives the tree's zero on it (``t0_perf_s``).

Cross-thread structure.  The runtime executes one query on several threads
(group worker, pilot-pool thread, the client's own thread for cached
serves).  Spans nest per thread: each thread that opens spans inside a
trace keeps its own open-span stack, and a span opened on a thread with no
enclosing span attaches to the root — so concurrent stages never interleave
into a bogus parent chain.  The *active* trace travels via a context var:
layers below the session (executor, physical compiler, staged catalog,
dist executor) call the module-level :func:`span` / :func:`annotate`
helpers and need no handle plumbing.

Closure contract.  ``QueryTrace.finish`` (called by the handle's
``_mark_done`` / ``_mark_failed``) closes every open span and the root —
so every COMPLETED, FALLBACK, or FAILED query yields a closed span tree,
including mid-group captured failures (the ErrorFrame path).
"""

from __future__ import annotations

import contextlib
import contextvars
import hashlib
import threading
import time
from typing import Dict, List, Optional, Sequence

import numpy as np

_ACTIVE: "contextvars.ContextVar[Optional[QueryTrace]]" = \
    contextvars.ContextVar("pilotdb_active_trace", default=None)
# the member counts of the stacked launches inside the drain-group span open
# on this context (group_span), None outside one
_LANES: "contextvars.ContextVar[Optional[List[int]]]" = \
    contextvars.ContextVar("pilotdb_group_lanes", default=None)

# a drain group's shared work, on every member: the stacked pilots and the
# batched finals (group_span)
GROUP_SPANS = ("group_pilots", "group_finals")


def _jsonable(v):
    """Coerce an attribute value to something ``json.dump`` accepts."""
    if isinstance(v, (bool, int, float, str)) or v is None:
        return v
    if isinstance(v, np.generic) or getattr(v, "ndim", None) == 0:
        return v.item()  # a numpy scalar or a 0-d array / tensor
    if isinstance(v, (list, tuple)):
        return [_jsonable(x) for x in v]
    if isinstance(v, dict):
        return {str(k): _jsonable(x) for k, x in v.items()}
    return repr(v)


def sig_hash(obj) -> str:
    """Short stable hash of a plan/compile signature for span attributes
    (the full signature repr is kilobytes; a 12-hex-char digest is enough
    to correlate compile spans with cache keys)."""
    return hashlib.blake2b(repr(obj).encode(), digest_size=6).hexdigest()


class Span:
    """One timed, attributed node of the span tree."""

    __slots__ = ("name", "t0", "t1", "attrs", "children", "status", "tid")

    def __init__(self, name: str, t0: Optional[float] = None):
        self.name = name
        self.t0 = time.perf_counter() if t0 is None else t0
        self.t1: Optional[float] = None
        self.attrs: Dict[str, object] = {}
        self.children: List["Span"] = []
        self.status = "ok"
        self.tid = threading.get_ident()

    @property
    def open(self) -> bool:
        return self.t1 is None

    @property
    def duration_s(self) -> float:
        return (time.perf_counter() if self.t1 is None else self.t1) - self.t0

    def set(self, **attrs) -> "Span":
        self.attrs.update(attrs)
        return self

    def to_dict(self, base: float) -> Dict[str, object]:
        return {
            "name": self.name,
            "t_start_s": self.t0 - base,
            "duration_s": self.duration_s,
            "status": self.status,
            "attrs": {k: _jsonable(v) for k, v in self.attrs.items()},
            "children": [c.to_dict(base) for c in self.children],
        }


class _NullSpan:
    """Shared no-op span: what instrumentation points get when no trace is
    active.  Supports the same surface as a live span context."""

    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False

    def set(self, **attrs):
        return self


NULL_SPAN = _NullSpan()


class _SpanCtx:
    """Context manager pairing a span with its trace's per-thread stack."""

    __slots__ = ("_trace", "_span")

    def __init__(self, trace: "QueryTrace", span: Span):
        self._trace = trace
        self._span = span

    def __enter__(self) -> Span:
        return self._span

    def __exit__(self, exc_type, exc, tb):
        if exc_type is not None:
            self._span.status = "error"
            self._span.attrs.setdefault(
                "error", f"{exc_type.__name__}: {exc}")
        self._trace._close(self._span)
        return False


class QueryTrace:
    """The span tree of one query; thread-safe, closed at completion."""

    def __init__(self, query_id: int, sql: Optional[str] = None,
                 t_start: Optional[float] = None):
        self._lock = threading.Lock()
        self.query_id = query_id
        self.t0 = time.perf_counter() if t_start is None else t_start
        self.root = Span("query", t0=self.t0)
        self.root.attrs["query_id"] = query_id
        if sql is not None:
            self.root.attrs["sql"] = sql
        # per-thread open-span stacks (root is the implicit stack bottom)
        self._stacks: Dict[int, List[Span]] = {}
        # cross-thread named spans (e.g. "schedule": opened at submission on
        # the client thread, closed by whatever worker starts the query)
        self._named: Dict[str, Span] = {}
        # drain-group spans (group_span): the group's work can outlast this
        # member's delivery, so finish() leaves them, and their thread's
        # spans beneath them, to close when the group's work does
        self._held: set = set()
        self.status: Optional[str] = None  # None while the query lives

    # -- recording ------------------------------------------------------------
    @property
    def finished(self) -> bool:
        return self.status is not None

    def _parent(self, tid: int) -> Span:
        stack = self._stacks.get(tid)
        return stack[-1] if stack else self.root

    def _live(self, tid: int) -> bool:
        """Whether the calling thread may still add to the tree: until
        :meth:`finish`, and after it beneath a held group span."""
        return not self.finished or bool(self._stacks.get(tid))

    def span(self, name: str, **attrs):
        """Open a nested span on the calling thread (context manager)."""
        return self._open(name, None, attrs)

    def _open(self, name: str, t0: Optional[float], attrs: dict,
              hold: bool = False):
        with self._lock:
            tid = threading.get_ident()
            if not self._live(tid):
                return NULL_SPAN
            sp = Span(name, t0=t0)
            sp.attrs.update(attrs)
            self._parent(tid).children.append(sp)
            self._stacks.setdefault(tid, []).append(sp)
            if hold:
                self._held.add(sp)
        return _SpanCtx(self, sp)

    def _close(self, sp: Span, t1: Optional[float] = None) -> None:
        with self._lock:
            if sp.t1 is None:  # finish() may have force-closed it already
                sp.t1 = time.perf_counter() if t1 is None else t1
            self._held.discard(sp)
            stack = self._stacks.get(sp.tid, [])
            if sp in stack:  # pop through sp (tolerates leaked children)
                del stack[stack.index(sp):]

    def record(self, name: str, duration_s: float = 0.0, *,
               t_end: Optional[float] = None, **attrs) -> Span:
        """Append an already-elapsed span ending at ``t_end`` (default now;
        used where the work ran elsewhere — e.g. a member's view of a shared
        pilot stage or of its advisory estimate, or a final that landed
        inside a batched dispatch)."""
        with self._lock:
            if self.finished:
                return Span(name)
            t1 = time.perf_counter() if t_end is None else t_end
            sp = Span(name, t0=t1 - max(0.0, duration_s))
            sp.t1 = t1
            sp.attrs.update(attrs)
            self._parent(threading.get_ident()).children.append(sp)
            return sp

    def open_span(self, name: str, *, t0: Optional[float] = None,
                  hold: bool = False, **attrs) -> None:
        """Open a NAMED root-attached span that another thread (or a later
        call) will close, starting at ``t0`` (default now; idempotent per
        name while open).  A ``hold`` span stays open through
        :meth:`finish`."""
        with self._lock:
            if self.finished or name in self._named:
                return
            sp = Span(name, t0=t0)
            sp.attrs.update(attrs)
            self.root.children.append(sp)
            self._named[name] = sp
            if hold:
                self._held.add(sp)

    def close_span(self, name: str, *, t1: Optional[float] = None,
                   **attrs) -> None:
        """Close the named span at ``t1`` (default now) and add ``attrs``
        (no-op where none is open under that name)."""
        with self._lock:
            sp = self._named.pop(name, None)
            if sp is not None:
                sp.attrs.update(attrs)
                self._held.discard(sp)
                if sp.t1 is None:
                    sp.t1 = time.perf_counter() if t1 is None else t1

    def annotate(self, **attrs) -> None:
        """Set attributes on the calling thread's innermost open span (the
        root when none) — how deep layers tag the enclosing stage span."""
        with self._lock:
            tid = threading.get_ident()
            if self._live(tid):
                self._parent(tid).attrs.update(attrs)

    def annotate_count(self, key: str, n: int = 1) -> None:
        """Increment a numeric attribute on the innermost open span (e.g.
        compile hits/misses observed while a stage executes)."""
        with self._lock:
            tid = threading.get_ident()
            if not self._live(tid):
                return
            attrs = self._parent(tid).attrs
            attrs[key] = int(attrs.get(key, 0)) + n

    def finish(self, status: str = "ok", **attrs) -> None:
        """Close every open span but the held group spans, and the root
        (idempotent).  Called from ``_mark_done`` / ``_mark_failed`` — so
        completed, fallback, and failed queries all end with a closed tree
        once their drain group's work is done."""
        with self._lock:
            if self.finished:
                return
            self.status = status
            t1 = time.perf_counter()
            for stack in self._stacks.values():
                for sp in stack:
                    if sp.t1 is None and sp not in self._held:
                        sp.t1 = t1
            # a thread keeps its held spans (the bottom of its stack)
            self._stacks = {tid: [sp for sp in stack if sp in self._held]
                            for tid, stack in self._stacks.items()}
            self._stacks = {tid: st for tid, st in self._stacks.items() if st}
            for name in [n for n, sp in self._named.items()
                         if sp not in self._held]:
                sp = self._named.pop(name)
                if sp.t1 is None:
                    sp.t1 = t1
            self.root.attrs.update(attrs)
            self.root.status = "ok" if status == "ok" else "error"
            self.root.t1 = t1

    # -- introspection / export ----------------------------------------------
    def open_spans(self) -> List[str]:
        """Names of spans still open (tests assert ``[]`` after completion;
        the root is included until :meth:`finish`)."""
        out: List[str] = []

        def walk(sp: Span) -> None:
            if sp.open:
                out.append(sp.name)
            for c in sp.children:
                walk(c)

        with self._lock:
            walk(self.root)
        return out

    def span_names(self) -> List[str]:
        """Every span name in the tree, preorder."""
        out: List[str] = []

        def walk(sp: Span) -> None:
            out.append(sp.name)
            for c in sp.children:
                walk(c)

        with self._lock:
            walk(self.root)
        return out

    def find(self, name: str, skip: Sequence[str] = ()) -> List[Span]:
        """All spans named ``name`` (preorder), outside the subtrees of spans
        named in ``skip``."""
        out: List[Span] = []

        def walk(sp: Span) -> None:
            if sp.name == name:
                out.append(sp)
            for c in sp.children:
                if c.name not in skip:
                    walk(c)

        with self._lock:
            walk(self.root)
        return out

    def to_dict(self) -> Dict[str, object]:
        """JSON-able span tree (times relative to trace start, seconds;
        ``t0_perf_s`` is that start on ``time.perf_counter``)."""
        with self._lock:
            return {
                "query_id": self.query_id,
                "t0_perf_s": self.t0,
                "status": self.status or "open",
                "duration_s": self.root.duration_s,
                "root": self.root.to_dict(self.t0),
            }

    def to_chrome(self) -> List[Dict[str, object]]:
        """Chrome trace-event format: a list of complete ("ph": "X") events
        — ``json.dump`` the list and load it in chrome://tracing/Perfetto.
        Thread ids are remapped to small ordinals per trace."""
        events: List[Dict[str, object]] = []
        tids: Dict[int, int] = {}

        def walk(sp: Span) -> None:
            tid = tids.setdefault(sp.tid, len(tids))
            events.append({
                "name": sp.name,
                "ph": "X",
                "ts": (sp.t0 - self.t0) * 1e6,
                "dur": sp.duration_s * 1e6,
                "pid": self.query_id,
                "tid": tid,
                "args": {k: _jsonable(v) for k, v in sp.attrs.items()},
            })
            for c in sp.children:
                walk(c)

        with self._lock:
            walk(self.root)
        return events


# -- context plumbing (what the engine layers call) ---------------------------

def activate(trace: Optional[QueryTrace]):
    """Make ``trace`` the calling thread's active trace; returns a token
    for :func:`deactivate` (None when ``trace`` is None — the no-op case).
    ALWAYS pair with deactivate in a finally: worker threads are pooled and
    a leaked context var would misattribute the next query's spans."""
    if trace is None:
        return None
    return _ACTIVE.set(trace)


def deactivate(token) -> None:
    if token is not None:
        _ACTIVE.reset(token)


def active() -> Optional[QueryTrace]:
    return _ACTIVE.get()


def span(name: str, **attrs):
    """Open a span on the active trace — the shared no-op when none.  This
    is the single instrumentation entry point for layers below the session
    (executor, compiler, staged catalog, dist executor)."""
    tr = _ACTIVE.get()
    if tr is None:
        return NULL_SPAN
    return tr.span(name, **attrs)


def annotate(**attrs) -> None:
    """Tag the active trace's innermost open span (no-op when untraced)."""
    tr = _ACTIVE.get()
    if tr is not None:
        tr.annotate(**attrs)


def annotate_count(key: str, n: int = 1) -> None:
    tr = _ACTIVE.get()
    if tr is not None:
        tr.annotate_count(key, n)


def note_lanes(n: int) -> None:
    """Count one stacked launch of ``n`` members for the drain-group span
    open on this context (:func:`group_span`); a no-op outside one."""
    lanes = _LANES.get()
    if lanes is not None:
        lanes.append(n)


@contextlib.contextmanager
def group_span(name: str, traces: Sequence[Optional[QueryTrace]]):
    """A drain group's shared work as one span on every member's trace.

    The span opens on the first member's trace, which stays active inside,
    so the draws, dispatches and reads of the work nest beneath it.  Every
    other member gets a root-attached copy with the same start and end, so
    no query's ``schedule`` span takes these seconds.  The spans are held:
    a member delivered inside (a batched final lands it early) finishes its
    tree, but its group span runs on to the group's end, and the first
    member's keeps taking the work's spans.  Each copy holds ``members``
    (the group's queries) and ``lanes``: the member count of each stacked
    launch inside (:func:`note_lanes`), a list where there is not exactly
    one.  Untraced members get nothing, and with none traced this does
    nothing."""
    others = [tr for tr in traces[1:] if tr is not None]
    lead = traces[0] if traces else None
    if lead is None and not others:
        yield
        return
    lanes: List[int] = []
    lanes_token = _LANES.set(lanes)
    token = activate(lead)
    t0 = time.perf_counter()
    ctx = NULL_SPAN if lead is None else lead._open(name, t0, {}, hold=True)
    sp = ctx._span if isinstance(ctx, _SpanCtx) else None
    for tr in others:
        tr.open_span(name, t0=t0, hold=True)
    error = None
    try:
        yield
    except BaseException as e:
        error = f"{type(e).__name__}: {e}"
        raise
    finally:
        t1 = time.perf_counter()
        deactivate(token)
        _LANES.reset(lanes_token)
        attrs = {"members": len(traces),
                 "lanes": lanes[0] if len(lanes) == 1 else lanes}
        if error is not None:
            attrs["error"] = error
        if sp is not None:
            with lead._lock:
                sp.attrs.update(attrs)
                if error is not None:
                    sp.status = "error"
            lead._close(sp, t1)
        for tr in others:
            tr.close_span(name, t1=t1, **attrs)
