"""``launch/roofline.py`` and ``launch/trace_analysis.py`` of the port
against the reference's ``roofline.py`` and ``hlo_analysis.py``, on the
CPU: parameter counts and MODEL_FLOPS of every arch x shape, ``analyze`` of
one synthetic dry-run JSON with the reference's three constants set to the
port's (on the reference's module object; its file is untouched), and the
ring formulas on ``tests/test_launch.py``'s synthetic HLO: its five
all-gathers and five dots, run as torch ops under ``TraceAnalysis`` in a
fake world of its four partitions.
"""

import json

import pytest
import torch

from repro.launch import roofline as ref_roofline
from repro.launch.hlo_analysis import analyze_hlo
from repro_torch.configs import list_architectures
from repro_torch.launch import roofline
from repro_torch.launch.mesh import fake_world
from repro_torch.launch.specs import SHAPES
from repro_torch.launch.trace_analysis import TraceAnalysis
from test_launch import SYNTH_HLO


@pytest.mark.parametrize("arch", list_architectures())
def test_param_counts_are_the_references(arch):
    assert roofline.param_counts(arch) == ref_roofline.param_counts(arch)


@pytest.mark.parametrize("shape", sorted(SHAPES))
@pytest.mark.parametrize("arch", list_architectures())
def test_model_flops_are_the_references(arch, shape):
    assert roofline.model_flops(arch, shape, 256) == ref_roofline.model_flops(arch, shape, 256)


def test_analyze_is_the_references_at_the_ports_constants(tmp_path, monkeypatch):
    cells = {
        "internlm2-1.8b|train_4k": {"status": "ok", "memory": {
            "argument_bytes": 1, "output_bytes": 2, "peak_bytes": 3 * 2**30, "temp_bytes": 3 * 2**30},
            "hlo_profile": {"flops_per_device": 2.5e14, "hbm_bytes_per_device": 4.1e12,
                            "collective_bytes_per_device": 9.0e11,
                            "collective_counts": {"all-gather": 7}, "num_partitions": 256}},
        "mistral-large-123b|decode_32k": {"status": "ok", "memory": {
            "argument_bytes": 1, "output_bytes": 2, "peak_bytes": 2**33, "temp_bytes": 2**33},
            "hlo_profile": {"flops_per_device": 1.2e11, "hbm_bytes_per_device": 6.0e10,
                            "collective_bytes_per_device": 1.0e9,
                            "collective_counts": {}, "num_partitions": 256}},
        "gemma-7b|long_500k": {"status": "skipped", "reason": "pure full attention"},
        "hymba-1.5b|train_4k": {"status": "failed", "error": "RuntimeError: x"},
    }
    path = tmp_path / "dryrun.json"
    path.write_text(json.dumps(cells))
    monkeypatch.setattr(ref_roofline, "PEAK_FLOPS", roofline.PEAK_FLOPS)
    monkeypatch.setattr(ref_roofline, "HBM_BW", roofline.HBM_BW)
    monkeypatch.setattr(ref_roofline, "ICI_BW", roofline.LINK_BW)
    got, want = roofline.analyze(str(path)), ref_roofline.analyze(str(path))
    assert got.keys() == want.keys()
    for key, row in want.items():
        port = dict(got[key])
        if row["status"] == "ok":
            assert port.pop("peak_gib") == row.pop("peak_temp_gib")
            port.pop("advice"), row.pop("advice")
            assert port["dominant"] in ("compute", "memory", "collective")
        assert port == row, key
    assert roofline.to_markdown(got).count("\n") == len(cells) + 1


def test_ring_formulas_are_the_references_on_the_synthetic_hlo():
    """Five (8, 16) x (16, 16) f32 products and five all-gathers of their
    (8, 16) f32 results over 4 ranks, the synthetic module's loop body."""
    want = analyze_hlo(SYNTH_HLO)
    with fake_world(4):
        group = torch.distributed.group.WORLD.group_name
        x, w = torch.ones(8, 16), torch.ones(16, 16)
        with TraceAnalysis(num_partitions=4) as trace:
            for _ in range(5):
                y = x @ w
                g = torch.ops._c10d_functional.all_gather_into_tensor(y, 4, group)
                torch.ops._c10d_functional.wait_tensor(g)
    got = trace.result()
    assert got["flops_per_device"] == want["flops_per_device"]
    assert got["collective_bytes_per_device"] == want["collective_bytes_per_device"]
    assert got["collective_counts"] == {"all-gather": 5} == \
        {k: int(v) for k, v in want["collective_counts"].items()}
    assert got["num_partitions"] == want["num_partitions"] == 4
