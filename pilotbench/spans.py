"""What the readers of the program's own spans share.  A record's spans are
``(path, start, end, depth)`` on the host clock, as
:func:`pilotbench.trace.flatten_spans` gives them; a path holds the names
of the span's ancestors (``query/pilot/scan/draw``)."""


def named(spans, name):
    """The spans called ``name`` that no other span of that name holds."""
    return [s for s in spans
            if s[0].rsplit("/", 1)[-1] == name and name not in s[0].split("/")[:-1]]


def seconds(spans, name):
    """The seconds of :func:`named` spans, summed."""
    return sum(end - start for _, start, end, _ in named(spans, name))
