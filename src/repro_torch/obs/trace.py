"""Query-lifecycle tracing: one span tree per :class:`QueryHandle`.

A :class:`QueryTrace` records the full life of a query as nested timed
spans — parse → lower → schedule → pilot (shared/solo, staged-rung,
shard-fanout tags) → rate solve (§4) → compile (hit/miss + signature) →
final dispatch (batched/solo/staged/per-shard) → deliver — with wall times,
``scanned_bytes`` and fallback reasons as span attributes.  Exportable as a
JSON span tree (:meth:`QueryTrace.to_dict`) or Chrome trace-event format
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

import contextvars
import dataclasses
import hashlib
import threading
import time
from typing import Dict, List, Optional

import numpy as np

_ACTIVE: "contextvars.ContextVar[Optional[QueryTrace]]" = \
    contextvars.ContextVar("pilotdb_active_trace", default=None)


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
        self.status: Optional[str] = None  # None while the query lives

    # -- recording ------------------------------------------------------------
    @property
    def finished(self) -> bool:
        return self.status is not None

    def _parent(self, tid: int) -> Span:
        stack = self._stacks.get(tid)
        return stack[-1] if stack else self.root

    def span(self, name: str, **attrs):
        """Open a nested span on the calling thread (context manager)."""
        with self._lock:
            if self.finished:
                return NULL_SPAN
            sp = Span(name)
            sp.attrs.update(attrs)
            tid = threading.get_ident()
            self._parent(tid).children.append(sp)
            self._stacks.setdefault(tid, []).append(sp)
        return _SpanCtx(self, sp)

    def _close(self, sp: Span) -> None:
        with self._lock:
            if sp.t1 is None:  # finish() may have force-closed it already
                sp.t1 = time.perf_counter()
            stack = self._stacks.get(sp.tid, [])
            if sp in stack:  # pop through sp (tolerates leaked children)
                del stack[stack.index(sp):]

    def record(self, name: str, duration_s: float = 0.0, **attrs) -> Span:
        """Append an already-elapsed span ending now (used where the work
        ran elsewhere — e.g. a member's view of a shared pilot stage, or a
        final that landed inside a batched dispatch)."""
        with self._lock:
            if self.finished:
                return Span(name)
            t1 = time.perf_counter()
            sp = Span(name, t0=t1 - max(0.0, duration_s))
            sp.t1 = t1
            sp.attrs.update(attrs)
            self._parent(threading.get_ident()).children.append(sp)
            return sp

    def open_span(self, name: str, **attrs) -> None:
        """Open a NAMED root-attached span that another thread will close
        (idempotent per name while open)."""
        with self._lock:
            if self.finished or name in self._named:
                return
            sp = Span(name)
            sp.attrs.update(attrs)
            self.root.children.append(sp)
            self._named[name] = sp

    def close_span(self, name: str, **attrs) -> None:
        """Close the named span if open (no-op otherwise)."""
        with self._lock:
            sp = self._named.pop(name, None)
            if sp is not None:
                sp.attrs.update(attrs)
                sp.t1 = time.perf_counter()

    def annotate(self, **attrs) -> None:
        """Set attributes on the calling thread's innermost open span (the
        root when none) — how deep layers tag the enclosing stage span."""
        with self._lock:
            if not self.finished:
                self._parent(threading.get_ident()).attrs.update(attrs)

    def annotate_count(self, key: str, n: int = 1) -> None:
        """Increment a numeric attribute on the innermost open span (e.g.
        compile hits/misses observed while a stage executes)."""
        with self._lock:
            if self.finished:
                return
            attrs = self._parent(threading.get_ident()).attrs
            attrs[key] = int(attrs.get(key, 0)) + n

    def finish(self, status: str = "ok", **attrs) -> None:
        """Close EVERY open span and the root (idempotent).  Called from
        ``_mark_done`` / ``_mark_failed`` — so completed, fallback, and
        failed queries all end with a closed tree."""
        with self._lock:
            if self.finished:
                return
            self.status = status
            t1 = time.perf_counter()
            for stack in self._stacks.values():
                for sp in stack:
                    if sp.t1 is None:
                        sp.t1 = t1
            self._stacks.clear()
            for sp in self._named.values():
                if sp.t1 is None:
                    sp.t1 = t1
            self._named.clear()
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

    def find(self, name: str) -> List[Span]:
        """All spans named ``name`` (preorder)."""
        out: List[Span] = []

        def walk(sp: Span) -> None:
            if sp.name == name:
                out.append(sp)
            for c in sp.children:
                walk(c)

        with self._lock:
            walk(self.root)
        return out

    def to_dict(self) -> Dict[str, object]:
        """JSON-able span tree (times relative to trace start, seconds)."""
        with self._lock:
            return {
                "query_id": self.query_id,
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
