"""group_ms.herd: the median over the window's refreshes of the seconds in
the drain groups' shared work, the program's ``group_pilots`` (stacked
pilots) and ``group_finals`` (batched finals) spans, over the refresh's
queries.  Every member of a group holds a copy of its span, all with one
start: each is counted once."""

from pilotbench.metrics import median_ms
from pilotbench.spans import named

NAMES = ("group_pilots", "group_finals")


def read(ctx):
    per = {}
    for r in ctx.records:
        if r.refresh is not None:
            per.setdefault(r.refresh, []).extend(
                (s[0].rsplit("/", 1)[-1], s[1], s[2])
                for name in NAMES for s in named(r.spans, name))
    v = []
    for k, spans in per.items():
        ends = {}
        for name, start, end in sorted(spans):
            # copies of one span share its start, up to the rounding of the
            # tree's times relative to each member's own zero
            key = next((key for key in ends if key[0] == name
                        and abs(key[1] - start) < 1e-6), (name, start))
            ends[key] = max(ends.get(key, end), end)
        if ends:
            v.append(sum(end - key[1] for key, end in ends.items())
                     / ctx.refreshes[k]["n_queries"])
    return median_ms(v)
