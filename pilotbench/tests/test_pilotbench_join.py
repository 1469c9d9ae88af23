"""Families over joined tables and samples over several tables: the
reference against a join written straight in numpy, the estimate of a
sample against a brute-force one, the single-table families read exactly as
before, and a whole CPU run of a two-table configuration, correct when
sound and not under the control or a fault in the timed path."""

import copy
import json
import time
from pathlib import Path

import numpy as np
import pytest
import torch

from pilotbench import check, harness, reference, tables
from pilotbench.traffic import make_query

CONFIG = json.loads((Path(__file__).resolve().parents[1] / "configs" / "tpch_sf10.json").read_text())
BR = 32


def two_table_config(lineitem_rows: int, part_rows: int, unmatched: int = 0) -> dict:
    """tpch_sf10's lineitem beside a TPC-H ``part`` of ``part_rows`` rows
    (dense keys, dbgen's retail price, the PROMO flag of its type), with
    ``l_partkey`` drawn over the part keys and ``unmatched`` keys past them;
    ``p_promo`` is part's column, not lineitem's."""
    cfg = copy.deepcopy(CONFIG)
    cfg["tables"] = ["lineitem", "part"]
    cfg["lineitem_rows"] = lineitem_rows
    cols = cfg["lineitem_columns"]
    del cols["p_promo"]
    cols["l_partkey"]["range"] = [1, part_rows + 1 + unmatched]
    cfg["part_rows"] = part_rows
    cfg["part_columns"] = {
        "p_partkey": {"dtype": "int32", "dist": "serial_key"},
        "p_retailprice": {"dtype": "float32", "dist": "tpch_retailprice", "of": "p_partkey"},
        "p_promo": {"dtype": "int8", "dist": "keyed_flag", "key": "p_partkey",
                    "keys": part_rows + 1, "range": [0, 150], "flag_in": [125, 150]},
    }
    return cfg


L_ROWS, P_ROWS = 64_000, 4_096


@pytest.fixture(scope="module")
def data():
    # 32 part keys with no part row: their lines drop out of the join
    return tables.make_tables(two_table_config(L_ROWS, P_ROWS, unmatched=32),
                              2 ** 31 + 9, "cpu")


def numpy_join(data):
    """lineitem's columns with part's at each line's key, by a sort and a
    search in numpy, and each row's (lineitem, part) row; unmatched lines
    left out."""
    li = {k: v.numpy() for k, v in data["lineitem"].items()}
    pa = {k: v.numpy() for k, v in data["part"].items()}
    order = np.argsort(pa["p_partkey"], kind="stable")
    pos = np.searchsorted(pa["p_partkey"][order], li["l_partkey"])
    pos = np.minimum(pos, len(order) - 1)
    hit = pa["p_partkey"][order][pos] == li["l_partkey"]
    prow = order[pos][hit]
    rows = {k: v[hit] for k, v in li.items()}
    rows.update({k: v[prow] for k, v in pa.items()})
    return rows, np.flatnonzero(hit), prow


def numpy_answer(c, family, p):
    ph = reference.family(family).placeholders(p)
    sd = c["l_shipdate"]
    m = (sd >= ph["date_lo"]) & (sd < ph["date_hi"])
    if family == "q14_join":
        rev = c["l_extendedprice"][m].astype(np.float64) * (1 - c["l_discount"][m].astype(np.float64))
        return np.array([[np.sum(rev * c["p_promo"][m]) / np.sum(rev)]])
    return np.array([[np.sum(c["l_quantity"][m].astype(np.float64)
                             * c["p_retailprice"][m].astype(np.float64))]])


CASES = [("q14_join", {"year": 1995, "month": 3}), ("q14_join", {"year": 1997, "month": 12}),
         ("retail_value", {"year": 1994})]


@pytest.mark.parametrize("family,params", CASES)
def test_join_family_exact_matches_a_numpy_join(data, family, params):
    rows, lrow, _ = numpy_join(data)
    assert 0 < len(lrow) < L_ROWS            # some lines find no part
    got, present = check.Reference(data, BR).exact(make_query(family, params, None))
    assert present.all()
    np.testing.assert_allclose(got, numpy_answer(rows, family, params), rtol=1e-12)


def test_retail_value_is_the_gross_extended_price(data):
    rows, _, _ = numpy_join(data)
    got, _ = check.Reference(data, BR).exact(make_query("retail_value", {"year": 1995}, None))
    sd = rows["l_shipdate"]
    ph = reference.family("retail_value").placeholders({"year": 1995})
    m = (sd >= ph["date_lo"]) & (sd < ph["date_hi"])
    np.testing.assert_allclose(got[0, 0], rows["l_extendedprice"][m].astype(np.float64).sum(),
                               rtol=1e-6)


def test_a_right_key_that_is_not_unique_is_refused():
    with pytest.raises(ValueError, match="not unique"):
        reference.key_map(torch.tensor([1, 2, 2]))
    assert reference.key_map(torch.tensor([3, 1])).tolist() == [-1, 1, -1, 0]
    with pytest.raises(ValueError, match="negative"):
        reference.key_map(torch.tensor([0, -1]))


SAMPLED = {"lineitem": ("lineitem",), "part": ("part",), "both": ("lineitem", "part")}


@pytest.mark.parametrize("family,params", CASES)
@pytest.mark.parametrize("sampled", list(SAMPLED))
def test_sample_estimate_over_a_join_matches_brute_force(data, family, params, sampled):
    rng = np.random.default_rng(11)
    rates = {"lineitem": 0.3, "part": 0.4}
    blocks = {"lineitem": L_ROWS // BR, "part": P_ROWS // BR}
    finals = []
    for t in SAMPLED[sampled]:
        ids = np.flatnonzero(rng.random(blocks[t]) < rates[t])
        finals.append(check.Final(t, rates[t], ids, blocks[t], len(ids)))
    q = make_query(family, params, (5, 95))
    got, _ = check.Reference(data, BR).sample(q, check.Sample(tuple(finals)))

    rows, lrow, prow = numpy_join(data)
    keep = np.ones(len(lrow), bool)
    for f, r in zip(finals, [lrow if f.table == "lineitem" else prow for f in finals]):
        keep &= np.isin(r // BR, f.ids)
    want = numpy_answer({k: v[keep] for k, v in rows.items()}, family, params)
    if family == "retail_value":
        # one sampled table: N / n; two: Horvitz-Thompson, 1 / (θ1 θ2)
        (f, *rest) = finals
        want *= 1.0 / (rates["lineitem"] * rates["part"]) if rest else f.n_total / f.n_sampled
    np.testing.assert_allclose(got, want, rtol=1e-12)


def test_a_sample_of_a_table_the_family_does_not_read_is_refused(data):
    q = make_query("q6", {"year": 1994, "discount": 0.06, "quantity": 24}, (5, 95))
    s = check.Sample((check.Final("part", 0.5, np.arange(4), P_ROWS // BR, 4),))
    with pytest.raises(ValueError, match="reads no table"):
        check.Reference(data, BR).sample(q, s)


# -- the single-table families read as the parent's reference read them ----

def legacy_exact_sums(cols, num_rows, fam, params_list, dtype=torch.float64):
    """The reference's exact sums before families could join, verbatim."""
    names = set(fam.COLUMNS) | ({fam.GROUP_BY} if fam.GROUP_BY else set())
    phs = [fam.placeholders(p) for p in params_list]
    acc = [None] * len(phs)
    for lo in range(0, num_rows, reference.CHUNK_ROWS):
        chunk = {c: cols[c][lo:lo + reference.CHUNK_ROWS] for c in names}
        values = reference._channel_values(fam, chunk, dtype)
        for i, ph in enumerate(phs):
            s = reference._channel_sums(fam, chunk, values, ph, dtype)
            acc[i] = s if acc[i] is None else acc[i] + s
    return [a.double().cpu().numpy() for a in acc]


def legacy_sample(cols, num_rows, block_rows, fam, params, f, dtype=torch.float64):
    """The reference's estimate over one table's sample before samples
    could span tables, verbatim: the sums over the blocks, scaled by N / n."""
    names = set(fam.COLUMNS) | ({fam.GROUP_BY} if fam.GROUP_BY else set())
    ids = f.id_array()
    idx = reference.block_rows_index(ids, block_rows, "cpu")
    idx = idx[idx < num_rows]
    chunk = {c: cols[c][idx] for c in names}
    values = reference._channel_values(fam, chunk, dtype)
    sums = reference._channel_sums(fam, chunk, values, fam.placeholders(params),
                                   dtype).double().cpu().numpy()
    return reference.compose(fam, sums, f.n_total / len(ids))


class LegacyReference:
    """:class:`check.Reference` as it stood for single-table samples."""

    def __init__(self, data, block_rows, dtype=torch.float64):
        self.ref = check.Reference(data, block_rows, dtype)
        self.rows = {t: int(next(iter(c.values())).shape[0]) for t, c in data.items()}

    def prefetch(self, queries):
        pass

    def exact(self, q):
        fam = reference.family(q.family)
        (sums,) = legacy_exact_sums(self.ref.tables[fam.TABLE], self.rows[fam.TABLE], fam,
                                    [q.params_dict], self.ref.dtype)
        return reference.compose(fam, sums)

    def sample(self, q, s):
        fam = reference.family(q.family)
        (f,) = s.finals
        return legacy_sample(self.ref.tables[fam.TABLE], self.rows[fam.TABLE],
                             self.ref.block_rows, fam, q.params_dict, f, self.ref.dtype)


SINGLE = [("q6", {"year": 1994, "discount": 0.06, "quantity": 24}), ("q1", {"delta": 90}),
          ("q14", {"year": 1995, "month": 12}), ("sum_count", {})]


@pytest.fixture(scope="module")
def lineitem():
    return tables.make_tables(dict(CONFIG, lineitem_rows=64_000), 2 ** 31 + 5, "cpu")


@pytest.mark.parametrize("dtype", [torch.float64, torch.bfloat16], ids=["reference", "control"])
@pytest.mark.parametrize("family,params", SINGLE)
def test_single_table_families_read_as_before(lineitem, family, params, dtype):
    ids = np.sort(np.random.default_rng(3).choice(2_000, 400, replace=False))
    s = check.Sample((check.Final("lineitem", 0.2, ids, 2_000, len(ids)),))
    q = make_query(family, params, (5, 95))
    new, old = check.Reference(lineitem, BR, dtype), LegacyReference(lineitem, BR, dtype)
    for a, b in zip(new.exact(q) + new.sample(q, s), old.exact(q) + old.sample(q, s)):
        assert np.array_equal(a, b, equal_nan=True)


def test_the_cpu_runs_checks_read_as_before():
    """The existing CPU run's answers, judged now and as before, read the
    same numbers, the control's too."""
    from pilotbench.tests.test_pilotbench_run import run
    out = run()
    old = LegacyReference(out.reference.tables, out.reference.block_rows)
    assert check.judge(out.answers, old, out.limits) == out.result["checks"]
    low = torch.bfloat16
    legacy_low = LegacyReference(out.reference.tables, out.reference.block_rows, low)
    new_low = check.Reference(out.reference.tables, out.reference.block_rows, low)
    assert (check.judge(check.control_answers(out.answers, legacy_low), out.reference, out.limits)
            == check.judge(check.control_answers(out.answers, new_low), out.reference, out.limits))


# -- a whole run of a two-table configuration ------------------------------

# a pilot of 3 % of lineitem's blocks, so that Q14's one month has a
# positive lower bound and reaches the plan
JOIN_MIX = {"mode": "sql",
            "session": {"async_workers": 0, "pilot_workers": 0, "result_cache_size": 0,
                        "spec_kwargs": {"theta_pilot": 0.03}},
            "queries": [{"family": "q14_join", "guarantee": [5, 95],
                         "params": {"year": [1995], "month": [3, 7]}},
                        {"family": "retail_value", "guarantee": [5, 95],
                         "params": {"year": [1994, 1996]}}]}
# Lemma 4.8's bound on part's share of the variance (one pilot column for
# each of part's 2,048 blocks) keeps part whole in every plan the planner
# finds at this size, so the run hands TAQA a plan that samples both
RATES = {"lineitem": 0.3, "part": 0.5}


def join_run(monkeypatch):
    from repro_torch.core import taqa
    from repro_torch.core.spec import SamplingPlan
    monkeypatch.setattr(taqa, "pick_plan", lambda *a, **k: SamplingPlan(rates=dict(RATES)))
    cell = harness.load_cell("tpch_sf10.q6_approx")
    cell.config = two_table_config(2_000_000, 65_536)
    cell.mix = JOIN_MIX
    return harness.run_cell("join", 2 ** 31 + 23, 1.0, False, t_process=time.perf_counter(),
                            device="cpu", cell=cell)


def test_join_run_is_correct_and_the_control_is_not(monkeypatch):
    from pilotbench.calibrate import control_checks
    out = join_run(monkeypatch)
    res = out.result
    assert res["correct"] and res["failed"] == 0
    assert res["checks"]["sample_gap"]["answers"] == res["attempted"] > 0
    assert {a.query.family for a in out.answers} == {"q14_join", "retail_value"}
    for a in out.answers:
        assert [(f.table, f.rate) for s in a.samples for f in s.finals] == list(RATES.items())
    assert not check.passed(control_checks(out, torch.bfloat16))


def _scaled_for_one_table(monkeypatch):
    from repro_torch.engine import executor

    def upscale(infos):
        sampled = [i for i in infos.values() if i.method == "block" and i.rate < 1.0]
        return sampled[0].n_total_blocks / sampled[0].n_sampled_blocks
    monkeypatch.setattr(executor.Executor, "_upscale", staticmethod(upscale))


def _part_block_left_out(monkeypatch):
    from repro_torch.engine import executor, sampling
    orig = executor.draw_blocks

    def draw(table, rate, seed):
        d = orig(table, rate, seed)
        if table.name != "part" or d.ids is None or len(d.ids) < 2:
            return d
        # the scan reads every drawn block but the first; the sample it
        # reports still holds it
        phys, n_real, n_phys = sampling.pad_block_ids(d.ids[1:], table.num_blocks)
        return sampling.BlockDraw(n_real, n_phys, ids=d.ids, phys=phys)
    monkeypatch.setattr(executor, "draw_blocks", draw)


@pytest.mark.parametrize("fault", [_scaled_for_one_table, _part_block_left_out],
                         ids=["scaled_as_if_one_table_sampled", "one_drawn_part_block_left_out"])
def test_a_join_fault_is_not_correct(monkeypatch, fault):
    fault(monkeypatch)
    assert not join_run(monkeypatch).result["correct"]
