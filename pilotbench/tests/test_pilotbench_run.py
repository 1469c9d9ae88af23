"""A whole run of the harness on the CPU at a small size, past its look for
a chip: sound, it comes out correct; with the control (the reference in
bfloat16 in the program's place) or with a fault planted in the program's
timed path, it does not."""

import copy
import json
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import pytest
import torch

from pilotbench import check, harness

ROOT = Path(__file__).resolve().parents[2]
# Exact Q6 and Q14 and an approximate SUM/COUNT: at this size the CPU's
# float32 sums of the grouped Q1 drift past the limit, and the approximate
# Q6 falls back to exact; the chip's runs cover both.
MIX = {"mode": "sql",
       "session": {"async_workers": 0, "pilot_workers": 0, "result_cache_size": 0},
       "queries": [{"family": "q6", "guarantee": None,
                    "params": {"year": [1994, 1996], "discount": [0.06], "quantity": [24]}},
                   {"family": "q14", "guarantee": None, "params": {"year": [1995], "month": [3]}},
                   {"family": "sum_count", "guarantee": [5, 95], "params": {}}]}


def small_cell(mix=MIX):
    cell = harness.load_cell("tpch_sf10.q6_approx")
    cell.config = copy.deepcopy(cell.config)
    cell.config["lineitem_rows"] = 2_000_000
    cell.mix = mix
    return cell


def run(mix=MIX):
    return harness.run_cell("small", 2 ** 31 + 17, 1.0, False, t_process=time.perf_counter(),
                            device="cpu", cell=small_cell(mix))


def test_sound_run_is_correct_and_the_control_is_not():
    from pilotbench.calibrate import control_checks
    out = run()
    res = out.result
    assert res["correct"] and res["failed"] == 0 and res["attempted"] > 0
    assert res["checks"]["exact_gap"]["answers"] > 0
    assert res["checks"]["sample_gap"]["answers"] > 0
    assert set(res["metrics"]) == {"setup_s", "query_p95_ms"}
    assert list(res)[-1] == "checks"
    assert not check.passed(control_checks(out, torch.bfloat16))
    json.dumps(res)


def test_refresh_mode_runs_the_same_check():
    mix = dict(MIX, mode="refresh", warm_refreshes=1)
    out = run(mix)
    res = out.result
    assert res["correct"] and res["attempted"] % 3 == 0   # three panels a refresh
    # the cell's single-query latencies have no single queries to read here
    assert set(res["metrics"]) == {"setup_s"}
    assert {a.query.family for a in out.answers} == {"q6", "q14", "sum_count"}


def _altered(monkeypatch):
    from repro_torch.engine import executor
    orig = executor.Executor._compose_values
    monkeypatch.setattr(executor.Executor, "_compose_values",
                        staticmethod(lambda *a: orig(*a) * 1.001))


def _half_sample(monkeypatch):
    from repro_torch.engine import executor
    orig = executor.pad_block_ids
    monkeypatch.setattr(executor, "pad_block_ids",
                        lambda ids, n: orig(ids[:max(len(ids) // 2, 1)], n))


def _stale(monkeypatch):
    from repro_torch.core import taqa
    orig, first = taqa._combine, {}

    def combine(q, comp_channels, values):
        out = orig(q, comp_channels, values)
        return first.setdefault(out.shape, out).copy()
    monkeypatch.setattr(taqa, "_combine", combine)


@pytest.mark.parametrize("fault", [_altered, _half_sample, _stale],
                         ids=["answer_altered", "half_the_sample_mean_over_rest",
                              "state_unchanged"])
def test_a_fault_in_the_timed_path_is_not_correct(monkeypatch, fault):
    fault(monkeypatch)
    assert not run().result["correct"]


@pytest.mark.parametrize("n", [10, 61, 80, 138, 1000])
def test_miss_limit_is_the_binomial_tail(n):
    from scipy.stats import binom
    k = round(check.miss_limit(n, 0.05) * n)
    assert binom.sf(k - 1, n, 0.05) >= check.MISS_ALPHA > binom.sf(k, n, 0.05)


def test_unmatched_final_reads_inf():
    q = harness.Query("sum_count", (), (5.0, 95.0), "x")
    a = check.Answer(q, np.array([[1.0], [2.0]]), np.array([True]), False, [])
    data = {"lineitem": {"l_extendedprice": torch.ones(64)}}
    out = check.judge([a], check.Reference(data, 32), {"exact_gap": 1e-4, "sample_gap": 1e-4})
    assert out["sample_gap"]["value"] == float("inf")


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")


@pytest.mark.cuda
def test_run_py_on_the_card(cuda, tmp_path):
    p = subprocess.run([sys.executable, str(ROOT / "pilotbench" / "run.py"),
                        "--workload", "tpch_sf10.q6_approx", "--seed", "2147483651",
                        "--seconds", "2", "--trace", "1"],
                       cwd=ROOT, capture_output=True, text=True, timeout=900)
    assert p.returncode == 0, p.stderr[-3000:]
    res = json.loads(p.stdout.strip().splitlines()[-1])
    assert res["correct"] and res["device"]["platform"] == "gpu"
    assert res["device"]["busy_s"] > 0 and "breakdown" in res
    assert p.stderr.strip().splitlines()[-1].startswith("check ")
