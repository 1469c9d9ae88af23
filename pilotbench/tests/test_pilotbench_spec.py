"""BENCHMARK.json against the benchmark's contract, and every file the
harness finds by name there."""

import json
import re
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
SPEC = json.loads((ROOT / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.\-]{1,16}$")
CELLS = [w["name"] for w in SPEC["workloads"]]


def one_line(s, n=200):
    return isinstance(s, str) and 1 <= len(s) <= n and "\n" not in s and "\t" not in s


def reports(metric, cell):
    return cell in metric.get("workloads", CELLS)


def test_keys_and_size():
    assert set(SPEC) == {"command", "paths", "run_seconds", "configs", "workloads",
                         "end_to_end", "per_layer"}
    assert (ROOT / "BENCHMARK.json").stat().st_size <= 64 * 1024
    assert 1 <= len(SPEC["command"]) <= 32 and all(one_line(w) for w in SPEC["command"])
    assert 1 <= len(SPEC["paths"]) <= 16
    for p in SPEC["paths"]:
        assert re.match(r"^[A-Za-z0-9_.\-/]{1,200}$", p) and not p.startswith("/")
        assert ".." not in p.split("/") and (ROOT / p).is_dir()
    for word in SPEC["command"][1:]:
        if "/" in word:
            assert any(word.startswith(p + "/") for p in SPEC["paths"])
            assert (ROOT / word).is_file()


def test_names_units_and_entries():
    names = {"configs": set(), "workloads": set(), "metrics": set()}
    for c in SPEC["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert NAME.match(c["name"]) and one_line(c["source"]) and one_line(c["why"])
        assert len(c["reduced"]) <= 16 and all(NAME.match(k) for k in c["reduced"])
        assert any(c["file"].startswith(p + "/") for p in SPEC["paths"])
        assert (ROOT / c["file"]).is_file()
        names["configs"].add(c["name"])
    for w in SPEC["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert NAME.match(w["name"]) and NAME.match(w["traffic"]) and one_line(w["why"])
        assert w["config"] in names["configs"]
        assert w["chips"] == 1
        names["workloads"].add(w["name"])
    assert len(names["workloads"]) == len(SPEC["workloads"]) <= 24
    assert len({(w["config"], w["traffic"]) for w in SPEC["workloads"]}) == len(CELLS)
    assert {w["config"] for w in SPEC["workloads"]} == names["configs"]
    for m in SPEC["end_to_end"] + SPEC["per_layer"]:
        assert NAME.match(m["name"]) and UNIT.match(m["unit"])
        assert m["better"] in ("lower", "higher")
        assert m["name"] not in names["metrics"]
        names["metrics"].add(m["name"])
        assert set(m.get("workloads", CELLS)) <= set(CELLS)


def test_end_to_end():
    e2e = {m["name"]: m for m in SPEC["end_to_end"]}
    assert 1 <= len(e2e) <= 16 and "setup_s" in e2e
    for m in SPEC["end_to_end"]:
        assert set(m) <= {"name", "unit", "better", "bound", "source", "workloads"}
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    assert "workloads" not in e2e["setup_s"]
    for cell in CELLS:
        mine = [m["name"] for m in SPEC["end_to_end"] if reports(m, cell)]
        assert "setup_s" in mine and len(mine) >= 2


def test_per_layer_cells_report_what_they_move():
    e2e = {m["name"]: m for m in SPEC["end_to_end"]}
    layers = {}
    for m in SPEC["per_layer"]:
        assert set(m) <= {"name", "unit", "better", "source", "layer", "moves", "workloads"}
        assert m["source"] in ("device_trace", "program_span", "program_counter", "host_clock")
        assert one_line(m["layer"]) and m["moves"] in e2e
        for cell in m.get("workloads", CELLS):
            assert reports(e2e[m["moves"]], cell), (m["name"], cell)
        if m["name"].endswith("_roofline") or "mfu" in m["name"]:
            assert m["unit"] == "%"
        layers.setdefault(m["name"].split(".")[0], set()).add(m["layer"])
    assert all(len(v) == 1 for v in layers.values())
    for cell in CELLS:
        assert any(reports(m, cell) for m in SPEC["per_layer"]), cell


def test_run_seconds_fit_the_check():
    rs = SPEC["run_seconds"]
    assert isinstance(rs, int) and 1 <= rs <= 51
    assert (2 + 14 * 24) * (rs + 60) + 24 * 2 * 90 + 1200 <= 43200


@pytest.mark.parametrize("cell", CELLS)
def test_every_file_a_cell_needs(cell):
    w = next(w for w in SPEC["workloads"] if w["name"] == cell)
    bench = ROOT / "pilotbench"
    assert (bench / "traffic" / f"{w['traffic']}.json").is_file()
    limits = json.loads((bench / "limits" / f"{cell}.json").read_text())
    assert {"exact_gap", "sample_gap"} <= set(limits)
    for m in SPEC["end_to_end"] + SPEC["per_layer"]:
        if reports(m, cell):
            assert (bench / "metrics" / f"{m['name']}.py").is_file(), m["name"]
