"""Thread-safe per-query frame buffer behind ``QueryHandle.stream()``.

One buffer per streaming handle.  Emission happens on whatever thread
executes the query (the caller's for synchronous paths, a runtime worker
for async drains); consumption happens on client threads through the
blocking iterator (:meth:`FrameBuffer.stream`) or registered callbacks
(:meth:`FrameBuffer.add_callback` — a server-push hook).

Contracts:

* frames are delivered in emission order with monotonically increasing
  ``seq``; the stream ends at the first terminal frame (exactly one is ever
  pushed — the emitting sites guarantee it, the buffer enforces it);
* a callback registered *after* frames were emitted is replayed the backlog
  first, in order, so late subscription never loses frames;
* iteration over a finished stream terminates without blocking; iteration
  over a live one blocks (up to ``timeout`` per frame) until the next frame
  or the terminal arrives.

Callbacks run under the buffer lock: they stay cheap (a server appends to
a bounded deque) and MUST NOT call back into the buffer.
"""

from __future__ import annotations

import threading
import time
from typing import Callable, Iterator, List, Optional

from repro_torch.stream.frames import Frame


class FrameBuffer:
    def __init__(self, query_id: int, t0: Optional[float] = None):
        self.query_id = query_id
        # the zero point of every frame's relative `emitted_at` stamp —
        # handles pass their submission instant (QueryHandle.t_submit);
        # default: buffer creation
        self.t0 = time.perf_counter() if t0 is None else t0
        self._cond = threading.Condition()
        self._frames: List[Frame] = []
        self._callbacks: List[Callable[[Frame], None]] = []
        self._closed = False

    # -- emission (runtime side) ----------------------------------------------
    def push(self, frame: Frame) -> Frame:
        """Emit one frame: stamps ``seq``/``t_emit``, wakes iterators,
        invokes callbacks in registration order.  Pushing after the terminal
        frame is a no-op (the stream already ended — a late duplicate
        completion must not grow a closed stream)."""
        with self._cond:
            if self._closed:
                return frame
            frame.seq = len(self._frames)
            frame.t_emit = time.perf_counter()
            # submit-relative latency stamp, monotone in seq (one clock)
            frame.emitted_at = frame.t_emit - self.t0
            self._frames.append(frame)
            if frame.terminal:
                self._closed = True
            for cb in self._callbacks:
                cb(frame)
            self._cond.notify_all()
        return frame

    # -- consumption (client side) --------------------------------------------
    @property
    def closed(self) -> bool:
        with self._cond:
            return self._closed

    def frames(self) -> List[Frame]:
        """Snapshot of everything emitted so far (no blocking)."""
        with self._cond:
            return list(self._frames)

    def add_callback(self, cb: Callable[[Frame], None]) -> None:
        """Register ``cb`` for every frame; already-emitted frames are
        replayed to it first (in order, under the lock) so registration
        time never changes what a subscriber observes."""
        with self._cond:
            for frame in self._frames:
                cb(frame)
            if not self._closed:
                self._callbacks.append(cb)

    def stream(self, timeout: Optional[float] = None) -> Iterator[Frame]:
        """Blocking frame iterator: yields every frame in order and stops
        after the terminal one.  ``timeout`` bounds each *wait for the next
        frame* (not the whole stream); expiry raises :class:`TimeoutError`.
        """
        i = 0
        while True:
            with self._cond:
                while i >= len(self._frames):
                    if self._closed:
                        return
                    if not self._cond.wait(timeout):
                        raise TimeoutError(
                            f"no frame for query {self.query_id} within "
                            f"{timeout}s (stream still open)")
                frame = self._frames[i]
            i += 1
            yield frame

    __iter__ = stream

    # -- drain accounting (scheduler side) ------------------------------------
    def emit_times(self) -> List[float]:
        with self._cond:
            return [f.t_emit for f in self._frames]

    def terminal_emit_time(self) -> Optional[float]:
        with self._cond:
            if self._frames and self._frames[-1].terminal:
                return self._frames[-1].t_emit
            return None
