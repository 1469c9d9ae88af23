"""The port stands alone: no JAX, nothing of the reference package, and the
card by default — a default-device entry point raises without CUDA."""

import os
import pathlib
import re
import subprocess
import sys

import pytest
import torch

import repro_torch
from repro_torch.api import Session
from repro_torch.dist import DistExecutor
from repro_torch.engine.datagen import tpch_catalog
from repro_torch.engine.executor import Executor
from repro_torch.configs import get_config
from repro_torch.kernels.block_agg import block_agg
from repro_torch.models import Model

ROOT = pathlib.Path(__file__).resolve().parents[1]
PKG = pathlib.Path(repro_torch.__file__).resolve().parent

# `import repro` / `from repro.x` / `from repro import`, but not repro_torch
_FORBIDDEN = re.compile(
    r"^\s*(import\s+jax\b|from\s+jax\b|import\s+repro\b(?!_)|from\s+repro\b(?!_))",
    re.MULTILINE)


def test_importing_the_port_loads_no_jax_and_no_reference():
    code = (
        "import importlib, pkgutil, sys\n"
        "import repro_torch\n"
        "for m in pkgutil.walk_packages(repro_torch.__path__, 'repro_torch.'):\n"
        "    importlib.import_module(m.name)\n"
        "bad = sorted(n for n in sys.modules if n == 'jax' or n.startswith('jax.')\n"
        "             or n.startswith('jaxlib') or n == 'repro' or n.startswith('repro.'))\n"
        "mods = sorted(n for n in sys.modules if n.startswith('repro_torch'))\n"
        "print('LOADED', len(mods))\n"
        "print('MODS', ' '.join(mods))\n"
        "print('BAD', bad)\n")
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    out = subprocess.run([sys.executable, "-c", code], env=env, cwd=str(ROOT),
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert "BAD []" in out.stdout, out.stdout
    loaded = int(out.stdout.split("LOADED ")[1].split()[0])
    assert loaded >= 25  # every module of the package was imported
    mods = set(out.stdout.split("MODS ")[1].split("\n")[0].split())
    # the gather route and the builder stand alone too
    assert {"repro_torch.api.builder", "repro_torch.kernels.segment_sum.ops",
            "repro_torch.kernels.segment_sum.ref"} <= mods
    # the serving path: scheduler and runtime stand alone too
    assert {"repro_torch.api.scheduler", "repro_torch.runtime",
            "repro_torch.runtime.pool", "repro_torch.runtime.result_cache",
            "repro_torch.runtime.shared_pilot"} <= mods
    # the eval path: evaluator, configs, model stack and its two kernels
    assert {"repro_torch.aqpeval.evaluator", "repro_torch.configs.registry",
            "repro_torch.configs.hymba_1p5b", "repro_torch.models.config",
            "repro_torch.models.layers", "repro_torch.models.linear_attn",
            "repro_torch.models.model", "repro_torch.kernels.flash_attn.ops",
            "repro_torch.kernels.flash_attn.ref",
            "repro_torch.kernels.gla_chunk.ops",
            "repro_torch.kernels.gla_chunk.ref"} <= mods
    # the sample catalog and the shard executor stand alone too
    assert {"repro_torch.engine.staged", "repro_torch.dist",
            "repro_torch.dist.shard", "repro_torch.dist.merge",
            "repro_torch.dist.executor"} <= mods
    # the fused path's kernels, the Quickr baseline and the eager oracle
    assert {"repro_torch.kernels.taqa_solve.ops", "repro_torch.kernels.taqa_solve.ref",
            "repro_torch.core.quickr", "repro_torch.core.equivalence",
            "repro_torch.engine.ops"} <= mods
    # streaming and observability stand alone too
    assert {"repro_torch.stream", "repro_torch.stream.buffer",
            "repro_torch.stream.frames", "repro_torch.obs",
            "repro_torch.obs.trace", "repro_torch.obs.metrics",
            "repro_torch.obs.audit", "repro_torch.obs.timeseries",
            "repro_torch.obs.slo", "repro_torch.obs.events"} <= mods
    # serving: the gateway, the dashboard, the slot engine, the MoE FFN and
    # the serving CLI stand alone too
    assert {"repro_torch.serve", "repro_torch.serve.sql_gateway",
            "repro_torch.serve.dashboard", "repro_torch.serve.engine",
            "repro_torch.models.moe", "repro_torch.launch",
            "repro_torch.launch.serve"} <= mods


def test_no_source_imports_jax_or_the_reference():
    scripts = [ROOT / "chip_smoke.py", ROOT / "examples" / "torch_approx_eval.py",
               ROOT / "examples" / "torch_aqp_analytics.py",
               ROOT / "examples" / "torch_quickstart.py",
               ROOT / "examples" / "torch_serve_llm.py"]
    files = sorted(PKG.rglob("*.py")) + scripts
    assert all(f.exists() for f in scripts)
    offenders = [str(f) for f in files if _FORBIDDEN.search(f.read_text())]
    assert offenders == []


def test_default_device_raises_without_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cat = tpch_catalog(2000, 32, device="cpu")
    hymba = get_config("hymba-1.5b").reduced()
    for make in (lambda: Session(cat), lambda: Executor(cat),
                 lambda: DistExecutor(cat),
                 lambda: tpch_catalog(2000, 32), lambda: Model(hymba)):
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            make()
    # asked for, the CPU runs
    h = Session(cat, device="cpu").sql("SELECT COUNT(*) AS n FROM lineitem")
    assert h.status == "done" and h.scalar("n") == 2000
    assert Model(hymba, device="cpu").embed.device.type == "cpu"


def test_tables_must_sit_on_the_session_device():
    cat = tpch_catalog(2000, 32, device="cpu")
    meta = {"lineitem": cat["lineitem"]}
    s = Session(meta, device="cpu")
    assert s.tables() == ["lineitem"]
    other = tpch_catalog(2000, 32, device="cpu")["orders"]
    other = other.__class__(name="orders",
                            columns={c: v.to("meta") for c, v in other.columns.items()},
                            block_rows=32, num_rows=other.num_rows,
                            valid=other.valid.to("meta"),
                            block_id=other.block_id.to("meta"))
    with pytest.raises(ValueError):
        s.register_table("orders", other)


def test_wrappers_never_take_the_plain_version_off_the_cpu():
    """Only a CPU tensor reaches the plain version; a tensor on any other
    non-CUDA device is refused, not silently computed."""
    v = torch.zeros(64, device="meta")
    m = torch.zeros(64, dtype=torch.bool, device="meta")
    ids = torch.zeros(2, dtype=torch.int32, device="meta")
    with pytest.raises(ValueError, match="cuda or cpu"):
        block_agg(v, m, 32, ids)


@pytest.mark.parametrize("name,loads,skips", [
    ("SqlGateway", "repro_torch.serve.sql_gateway", "repro_torch.models"),
    ("GatewayStats", "repro_torch.serve.sql_gateway", "repro_torch.models"),
    ("render_dashboard", "repro_torch.serve.dashboard", "repro_torch.models"),
    ("ServeEngine", "repro_torch.serve.engine", "repro_torch.api"),
])
def test_serve_exports_are_lazy(name, loads, skips):
    """``repro_torch.serve`` resolves each export on first access: the SQL
    gateway does not import the model stack, and the slot engine does not
    import the query engine."""
    code = (
        "import sys\n"
        "import repro_torch.serve as serve\n"
        "assert not any(m.startswith('repro_torch.serve.') for m in sys.modules)\n"
        f"getattr(serve, {name!r})\n"
        f"assert {loads!r} in sys.modules\n"
        f"bad = sorted(m for m in sys.modules if m == {skips!r} or m.startswith({skips!r} + '.'))\n"
        "print('BAD', bad)\n")
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    out = subprocess.run([sys.executable, "-c", code], env=env, cwd=str(ROOT),
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert "BAD []" in out.stdout, out.stdout
    import repro_torch.serve as serve
    with pytest.raises(AttributeError):
        serve.NoSuchThing


def test_serving_entry_points_raise_without_cuda(monkeypatch):
    from repro_torch.launch import serve as launch_serve
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for arch in ("granite-moe-1b-a400m", "olmoe-1b-7b"):
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            Model(get_config(arch).reduced())
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        launch_serve.main(["--reduced"])
