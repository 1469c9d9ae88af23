"""host_reads_per_query: the program's ``host_read`` spans of the window's
single queries over those queries: each is one wait of the host on the
device (a device-to-host read, or a copy from host memory that waits for
the stream; ``engine/syncs.py``)."""

from pilotbench.metrics import single
from pilotbench.spans import named


def read(ctx):
    recs = single(ctx)
    n = sum(len(named(r.spans, "host_read")) for r in recs)
    return n / len(recs) if n else None
