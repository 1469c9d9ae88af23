"""``refresh``: a closed loop of refreshes; a refresh submits one query a
panel and drains them.  Each panel takes the next parameter set of its
entry's cycle, reshuffled every pass.  Set-up asks ``warm_refreshes``
refreshes of their own draw."""

from pilotbench.traffic import cycle, make_query


def refreshes(traffic, stream: int):
    rng = traffic.rng(stream)
    cycles = [(family, cycle(sets, rng), gs) for family, sets, gs in traffic.entries]
    while True:
        yield [make_query(family, next(cyc), g) for family, cyc, gs in cycles for g in gs]


def warm(traffic):
    it = refreshes(traffic, 1)
    return [next(it) for _ in range(int(traffic.mix.get("warm_refreshes", 1)))]


def batches(traffic):
    return refreshes(traffic, 0)


def min_batches(traffic):
    return 1


def ask(session, queries):
    hs = [session.submit(q.sql) for q in queries]
    session.drain()
    return hs


def stats(session):
    st = session.scheduler.last_drain
    return {"n_queries": st.n_queries, "pilots_run": st.pilots_run}
