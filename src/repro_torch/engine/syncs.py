"""The host's waits on the device, each in a ``host_read`` span.

Every device→host read on the query path goes through :func:`host_read`,
and so does every other call that makes the host wait for the card: a copy
between the card and pageable host memory returns only once the stream has
run up to it.  One helper names and counts them all, so the span tree shows
each wait and the benchmark's ``host_reads_per_query`` counts them.  The
span's time is the wait for the work queued before the read plus the copy.
"""

from __future__ import annotations

from repro_torch.obs import trace as _trace


def host_read(*arrays):
    """A ``host_read`` span around one wait of the host on the device, whose
    ``bytes`` attribute is the size of ``arrays`` (the tensors or numpy
    arrays it moves; None entries count nothing).  The shared no-op span
    when untraced: one context-variable read."""
    tr = _trace.active()
    if tr is None:
        return _trace.NULL_SPAN
    return tr.span("host_read",
                   bytes=sum(int(a.nbytes) for a in arrays if a is not None))
