"""``sql``: one client in a closed loop of ``Session.sql``.  The queries come
in passes; each pass asks every query of the mix once, in an order drawn
from the seed, so every seed runs the same work.  Set-up asks every query
once."""

from pilotbench.traffic import cycle


def warm(traffic):
    return [[q] for q in traffic.distinct()]


def batches(traffic):
    return ([q] for q in cycle(traffic.distinct(), traffic.rng(0)))


def min_batches(traffic):
    return len(traffic.distinct())


def ask(session, queries):
    (q,) = queries
    return [session.sql(q.sql)]


def stats(session):
    return None
