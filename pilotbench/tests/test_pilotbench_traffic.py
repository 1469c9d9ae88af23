"""The traffic generator: deterministic by seed, the same work for every
seed, inside TPC-H's substitution ranges, and SQL the port parses."""

import json
import re
from collections import Counter
from pathlib import Path

import pytest

from pilotbench import traffic
from pilotbench.reference import tpch_days

MIXES = sorted(p.stem for p in (Path(__file__).resolve().parents[1] / "traffic").glob("*.json"))


def load(mix):
    return json.loads((Path(__file__).resolve().parents[1] / "traffic" / f"{mix}.json").read_text())


def take(it, n):
    return [next(it) for _ in range(n)]


@pytest.mark.parametrize("mix", MIXES)
def test_same_seed_same_queries(mix):
    m = load(mix)
    a, b = traffic.Traffic(m, 2 ** 31 + 11), traffic.Traffic(m, 2 ** 31 + 11)
    assert take(a.batches(), 300) == take(b.batches(), 300)
    assert a.warm() == b.warm()


@pytest.mark.parametrize("mix", [m for m in MIXES if load(m)["mode"] == "sql"])
def test_every_pass_asks_every_query_once(mix):
    m = load(mix)
    distinct = traffic.Traffic(m, 0).distinct()
    n = len(distinct)
    for seed in (1, 2, 3 ** 20):
        seq = [q for (q,) in take(traffic.Traffic(m, seed).batches(), 2 * n)]
        assert Counter(q.key for q in seq[:n]) == Counter(q.key for q in distinct)
        assert Counter(q.key for q in seq[n:]) == Counter(q.key for q in distinct)
    orders = {tuple(q.key for (q,) in take(traffic.Traffic(m, s).batches(), n))
              for s in (1, 2, 3)}
    assert len(orders) == 3 or n < 3


def test_refresh_panels():
    m = load("dashboard_refresh")
    r = take(traffic.Traffic(m, 5).batches(), 10)
    assert all(len(x) == 24 for x in r)
    fams = Counter(q.family for q in r[0])
    assert fams == {"q6": 12, "sum_count": 6, "q1": 3, "q14": 3}
    errors = [q.guarantee[0] for q in r[0] if q.family == "sum_count"]
    assert errors == [5, 6, 7, 8, 5, 6]
    # each family's cycle: the first 80 Q6 panels are the 80 parameter sets
    q6 = [q.params for x in r[:7] for q in x if q.family == "q6"][:80]
    assert len(set(q6)) == 80


def test_tpch_ranges():
    q6 = traffic.Traffic(load("q6_approx"), 9).distinct()
    assert len(q6) == 5 * 8 * 2
    for q in q6:
        p = q.params_dict
        assert 1993 <= p["year"] <= 1997 and p["quantity"] in (24, 25)
        assert 0.02 <= p["discount"] <= 0.09
        lo, hi = (int(x) for x in re.findall(
            r"l_shipdate >= (\d+) AND l_shipdate < (\d+)", q.sql)[0])
        assert (lo, hi) == (tpch_days(p["year"]), tpch_days(p["year"] + 1))
        d = p["discount"]
        assert f"BETWEEN {d - 0.01:.2f} AND {d + 0.01:.2f}" in q.sql
        assert q.sql.endswith("ERROR 5% CONFIDENCE 95%")
    q1 = traffic.Traffic(load("q1_exact"), 9).distinct()
    assert sorted(q.params_dict["delta"] for q in q1) == list(range(60, 121))
    for q in q1:
        assert f"l_shipdate <= {2526 - q.params_dict['delta']} " in q.sql
        assert "ERROR" not in q.sql


@pytest.mark.parametrize("mix", MIXES)
def test_sql_parses(mix):
    from repro_torch.api.sql import parse_sql
    for q in traffic.Traffic(load(mix), 0).distinct():
        parsed = parse_sql(q.sql)
        if q.guarantee is None:
            assert parsed.spec is None
        else:
            assert parsed.spec.error == pytest.approx(q.guarantee[0] / 100)
            assert parsed.spec.confidence == pytest.approx(q.guarantee[1] / 100)


def test_modes_are_found_by_name():
    m = load("q6_approx")
    assert traffic.Traffic(m, 1).mode.__name__ == "pilotbench.modes.sql"
    with pytest.raises(ValueError):
        traffic.Traffic(dict(m, mode="../sql"), 1)
    with pytest.raises(ModuleNotFoundError):
        traffic.Traffic(dict(m, mode="no_such_mode"), 1)
