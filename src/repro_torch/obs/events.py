"""Flight recorder: append-only, size-rotated JSONL query-event log.

One compact record per lifecycle event — ``submit`` / ``pilot`` /
``rate_solve`` / ``final`` / ``deliver`` / ``fallback`` / ``fail`` /
``audit`` / ``slo_breach`` / ``trace`` (a sampled span tree, see
``SessionConfig.trace_sample``) — so an operator can reconstruct what a
serving session did long after its in-memory state is gone.  Records are
single JSON lines::

    {"seq": 17, "t": 1754700000.123, "ev": "deliver", "qid": 4,
     "template": "9f2a66c01b7d", "latency_s": 0.0312, ...}

``seq`` is a per-recorder monotone counter (gap-free unless records were
dropped), ``t`` is wall-clock epoch seconds, ``ev`` the event type; the
remaining fields are event-specific (schema in docs/observability.md).

Fault contract.  The recorder NEVER raises into the query path: the file
is opened lazily on first emit, and any I/O failure (unwritable target,
disk full, rotation race) increments ``dropped`` and returns — answers are
unaffected and the next emit retries.  Rotation is size-based: when the
current file would exceed ``max_bytes``, it shifts to ``path.1`` (existing
``path.N`` shift up; the oldest past ``max_files - 1`` is deleted) and a
fresh file opens, so the log's disk footprint is bounded by roughly
``max_bytes * max_files``.

Replay.  :func:`replay` iterates every surviving record oldest-first
(rotated files before the live one, corrupt lines skipped);
:func:`rebuild_timeseries` replays ``deliver`` / ``fail`` / ``audit``
events (audits that ran, not skipped ones) into a fresh :class:`repro_torch.obs.timeseries.TemplateTimeSeries`, so
the windowed quantiles of a crashed (or remote) session can be rebuilt
offline from its log alone.
"""

from __future__ import annotations

import json
import os
import threading
import time
from typing import Dict, Iterator, Optional

from repro_torch.obs.timeseries import TemplateTimeSeries

__all__ = ["FlightRecorder", "replay", "rebuild_timeseries"]


def _json_default(v):
    """Last-resort coercion so a stray numpy scalar (or any object) can
    never make ``emit`` raise."""
    item = getattr(v, "item", None)
    if callable(item):
        try:
            return item()
        except Exception:
            pass
    return repr(v)


class FlightRecorder:
    """Append-only JSONL event log with size rotation (thread-safe)."""

    def __init__(self, path: str, *, max_bytes: int = 1 << 20,
                 max_files: int = 3):
        self.path = str(path)
        self.max_bytes = max(1024, int(max_bytes))
        self.max_files = max(1, int(max_files))
        self._lock = threading.Lock()
        self._fh = None           # lazily opened: a bad path must not raise
        self._size = 0
        self._seq = 0
        self.emitted = 0
        self.dropped = 0
        self.rotations = 0

    # -- emission (never raises) ----------------------------------------------
    def emit(self, ev: str, **fields) -> bool:
        """Append one event record; returns False (and counts a drop) on any
        failure instead of raising into the query path."""
        try:
            with self._lock:
                self._seq += 1
                rec = {"seq": self._seq, "t": time.time(), "ev": ev}
                rec.update(fields)
                line = json.dumps(rec, separators=(",", ":"),
                                  default=_json_default) + "\n"
                data = line.encode("utf-8")
                if self._fh is not None \
                        and self._size + len(data) > self.max_bytes \
                        and self._size > 0:
                    self._rotate_locked()
                if self._fh is None:
                    self._open_locked()
                self._fh.write(data)
                self._fh.flush()
                self._size += len(data)
                self.emitted += 1
                return True
        except Exception:
            # unwritable target / disk full / closed interpreter: the query
            # path must not observe recorder trouble
            with self._lock:
                self.dropped += 1
            return False

    def _open_locked(self) -> None:
        self._fh = open(self.path, "ab")
        self._size = self._fh.tell()
        if self._size > self.max_bytes:  # resumed onto an oversized log
            self._rotate_locked()
            if self._fh is None:
                self._open_locked()

    def _rotate_locked(self) -> None:
        if self._fh is not None:
            self._fh.close()
            self._fh = None
        self._size = 0
        if self.max_files <= 1:
            # single-file budget: truncate in place
            open(self.path, "wb").close()
        else:
            oldest = f"{self.path}.{self.max_files - 1}"
            if os.path.exists(oldest):
                os.remove(oldest)
            for i in range(self.max_files - 2, 0, -1):
                src = f"{self.path}.{i}"
                if os.path.exists(src):
                    os.replace(src, f"{self.path}.{i + 1}")
            if os.path.exists(self.path):
                os.replace(self.path, f"{self.path}.1")
        self.rotations += 1

    def close(self) -> None:
        with self._lock:
            if self._fh is not None:
                try:
                    self._fh.close()
                except Exception:
                    pass
                self._fh = None

    # -- introspection --------------------------------------------------------
    def stats(self) -> Dict[str, int]:
        with self._lock:
            return {"emitted": self.emitted, "dropped": self.dropped,
                    "rotations": self.rotations}


# -- offline replay -----------------------------------------------------------

def replay(path: str, max_files: int = 16) -> Iterator[dict]:
    """Yield every surviving event record oldest-first: rotated files
    (``path.N`` descending N) before the live file; unreadable files and
    corrupt lines are skipped, so a log torn mid-write still replays."""
    candidates = [f"{path}.{i}" for i in range(max_files, 0, -1)] + [path]
    for fname in candidates:
        try:
            fh = open(fname, "r", encoding="utf-8", errors="replace")
        except OSError:
            continue
        with fh:
            for line in fh:
                line = line.strip()
                if not line:
                    continue
                try:
                    rec = json.loads(line)
                except ValueError:
                    continue  # torn tail of a rotated/crashed write
                if isinstance(rec, dict) and "ev" in rec:
                    yield rec


def rebuild_timeseries(events, *, window: int = 256,
                       max_templates: int = 64) -> TemplateTimeSeries:
    """Replay ``deliver`` / ``fail`` / ``audit`` events into a fresh
    :class:`TemplateTimeSeries` — the offline reconstruction of a session's
    per-template windowed quantiles.  ``events`` is an iterable of record
    dicts (e.g. from :func:`replay`) or a recorder log path, which is
    replayed across its rotations first."""
    if isinstance(events, (str, os.PathLike)):
        events = replay(os.fspath(events))
    ts = TemplateTimeSeries(window=window, max_templates=max_templates)
    for ev in events:
        etype = ev.get("ev")
        key: Optional[str] = ev.get("template")
        if key is None:
            continue
        if etype == "deliver":
            ts.record_delivery(
                key, sql=ev.get("sql"),
                latency_s=float(ev.get("latency_s", 0.0)),
                pilot_wall_s=float(ev.get("pilot_wall_s", 0.0)),
                scanned_bytes=float(ev.get("scanned_bytes", 0)),
                cached=bool(ev.get("cached")), shared=bool(ev.get("shared")),
                fused=bool(ev.get("fused")), staged=bool(ev.get("staged")),
                fallback=bool(ev.get("fallback")))
        elif etype == "fail":
            ts.record_delivery(key, latency_s=float(ev.get("latency_s", 0.0)),
                               failed=True)
        elif etype == "audit" and ev.get("skipped") is None:
            # a skipped audit (the answer was exact) is logged but never
            # enters the live series (Session._observe_audit); the
            # reference's rebuild counts it, the port's does not
            ts.record_audit(key, float(ev.get("ratio", 0.0)),
                            bool(ev.get("passed", True)))
    return ts
