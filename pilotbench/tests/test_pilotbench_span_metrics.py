"""The readers of the program's own spans and counters, on synthetic runs:
nested spans, a run with nothing to read, and a drain group's span recorded
on several members."""

from types import SimpleNamespace

import pytest

from pilotbench.harness import reader
from pilotbench.spans import named, seconds


def rec(spans, *, approx=True, report=None, refresh=None):
    rep = {"pilot_ran": approx, "ppf_calls": 40} if report is None else report
    return SimpleNamespace(query=SimpleNamespace(guarantee=(5.0, 95.0) if approx else None),
                           report=rep, refresh=refresh, spans=spans)


def run(records, refreshes=()):
    return SimpleNamespace(records=list(records), refreshes=list(refreshes))


def sp(path, start, end):
    return (path, start, end, path.count("/"))


def query(t, draw=(0.002, 0.003), advisory=0.001, reads=(0.0005, 0.0002, 0.0001)):
    """A solo approximate query's spans from time ``t``: a pilot and a final,
    each scan with its draw, its dispatch and reads inside and after it."""
    out = [sp("query", t, t + 0.05)]
    at = t
    for stage, d in zip(("pilot", "final"), draw):
        out += [sp(f"query/{stage}", at, at + 0.01), sp(f"query/{stage}/scan", at, at + 0.01),
                sp(f"query/{stage}/scan/draw", at, at + d),
                sp(f"query/{stage}/scan/dispatch", at + d, at + d + 0.001),
                sp(f"query/{stage}/scan/dispatch/host_read", at + d, at + d + reads[0])]
        out += [sp(f"query/{stage}/scan/host_read", at + 0.005, at + 0.005 + r) for r in reads[1:]]
        at += 0.02
    out.append(sp("query/advisory", t + 0.011, t + 0.011 + advisory))
    return out


def test_helpers_count_outermost_spans():
    spans = [sp("query/final/scan/draw", 0.0, 2.0), sp("query/final/scan/draw/draw", 0.5, 1.0),
             sp("query/pilot/draw_x", 0.0, 9.0)]
    assert named(spans, "draw") == spans[:1]
    assert seconds(spans, "draw") == pytest.approx(2.0)
    assert named(spans, "advisory") == [] and seconds(spans, "advisory") == 0


def test_stage_readers_over_approximate_queries():
    ctx = run([rec(query(0.0, draw=(0.002, 0.004), advisory=0.001)),
               rec(query(1.0, draw=(0.003, 0.003), advisory=0.003),
                   report={"pilot_ran": True, "ppf_calls": 60}),
               rec(query(2.0, draw=(0.001, 0.001), advisory=0.002),
                   report={"pilot_ran": True, "ppf_calls": 50}),
               # an exact query: its spans count for the reads, not the stages
               rec([sp("query", 3.0, 3.1), sp("query/exact/scan/dispatch/host_read", 3.0, 3.01)],
                   approx=False, report={"pilot_ran": False, "ppf_calls": 0})])
    assert reader("draw_ms")(ctx) == pytest.approx(6.0)        # 6, 6, 2 ms
    assert reader("advisory_ms")(ctx) == pytest.approx(2.0)    # 1, 3, 2 ms
    assert reader("ppf_calls_per_query")(ctx) == 50.0          # 40, 60, 50
    assert reader("host_reads_per_query")(ctx) == pytest.approx((6 + 6 + 6 + 1) / 4)
    # each query's reads summed: 2 x (0.5 + 0.2 + 0.1) ms, and 10 ms for the exact
    assert reader("host_read_ms")(ctx) == pytest.approx(1.6)


@pytest.mark.parametrize("name", ["draw_ms", "advisory_ms", "ppf_calls_per_query",
                                  "host_reads_per_query", "host_read_ms", "group_ms.herd"])
def test_nothing_to_read_is_none(name):
    """A run of a program that has none of these spans or counters (the parent
    of the change that added them) reads None, and so does an empty run."""
    bare = rec([sp("query", 0.0, 1.0), sp("query/pilot/scan", 0.0, 0.5)],
               report={"pilot_ran": True})
    assert reader(name)(run([bare], [{"n_queries": 1}])) is None
    assert reader(name)(run([])) is None


def test_group_ms_counts_a_span_on_several_members_once():
    # refresh 0: three members; the stacked pilots are one span on each (the
    # copies' starts differ by rounding), the batched finals too, whose copies
    # count to the latest end among them
    r0 = [rec([sp("query", 0.0, 1.0), sp("query/schedule", 0.0, 0.1),
               sp("query/group_pilots", 0.1, 0.3), sp("query/group_pilots/scan", 0.1, 0.2),
               sp("query/group_finals", 0.5, 0.9)], refresh=0),
          rec([sp("query", 0.0, 1.0), sp("query/group_pilots", 0.1 + 1e-9, 0.3),
               sp("query/group_finals", 0.5, 0.9)], refresh=0),
          rec([sp("query", 0.0, 0.7), sp("query/group_pilots", 0.1, 0.3),
               sp("query/group_finals", 0.5 - 1e-9, 0.7)], refresh=0)]
    # refresh 1: two groups in one refresh of four queries, one member each
    r1 = [rec([sp("query", 2.0, 3.0), sp("query/group_finals", 2.2, 2.4)], refresh=1),
          rec([sp("query", 2.0, 3.0), sp("query/group_finals", 2.5, 2.6)], refresh=1),
          rec([sp("query", 2.0, 3.0)], refresh=1), rec([sp("query", 2.0, 3.0)], refresh=1)]
    # refresh 2 shares no group work
    r2 = [rec([sp("query", 4.0, 5.0)], refresh=2)]
    ctx = run(r0 + r1 + r2, [{"n_queries": 3}, {"n_queries": 4}, {"n_queries": 1}])
    # refresh 0: (0.2 + 0.4) / 3 = 200 ms; refresh 1: 0.3 / 4 = 75 ms
    assert reader("group_ms.herd")(ctx) == pytest.approx((200.0 + 75.0) / 2)
    # single queries hold no refresh's group work
    assert reader("group_ms.herd")(run([rec(query(0.0))])) is None
