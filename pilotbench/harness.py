"""One run of one cell: set-up, the measured window, the reference check and
the metrics, as :mod:`pilotbench.run` prints them.

Everything that belongs to one cell is found by name: the workload and its
configuration in ``BENCHMARK.json``, the configuration's file (its columns'
distributions in ``pilotbench/dists/``), the mix in
``pilotbench/traffic/<traffic>.json`` (its mode in ``pilotbench/modes/``),
the limits of the comparison in ``pilotbench/limits/<workload>.json`` and
each metric's reader in ``pilotbench/metrics/<metric>.py`` (a ``read(ctx)``
that returns a number, or None where the run holds nothing to read).

From the program the harness takes its front door (``Session``,
``SessionConfig``, ``BlockTable``, ``Session.register_table``), what each answer reports
(``TaqaReport``, ``DrainStats``), its span trees in a traced run, and the
block sample of each final, every sampled table of it, recorded as the
executor returns it.
"""

from __future__ import annotations

import dataclasses
import gc
import importlib.util
import json
import sys
import time
from pathlib import Path
from types import SimpleNamespace
from typing import Dict, List, Optional

import numpy as np
import torch

from pilotbench import check, tables, trace
from pilotbench.traffic import Query, Traffic

ROOT = Path(__file__).resolve().parents[1]
FORBIDDEN = ("jax", "jaxlib", "flax", "repro")


def load_json(path: Path):
    with open(path) as f:
        return json.load(f)


@dataclasses.dataclass
class Cell:
    workload: str
    entry: dict
    config: dict
    mix: dict
    limits: dict
    end_to_end: List[dict]
    per_layer: List[dict]


def load_cell(workload: str) -> Cell:
    spec = load_json(ROOT / "BENCHMARK.json")
    entry = next((w for w in spec["workloads"] if w["name"] == workload), None)
    if entry is None:
        raise SystemExit(f"no workload {workload!r} in BENCHMARK.json")
    cfg = next(c for c in spec["configs"] if c["name"] == entry["config"])

    def mine(metrics):
        return [m for m in metrics if workload in m.get("workloads", [workload])]

    return Cell(workload, entry, load_json(ROOT / cfg["file"]),
                load_json(ROOT / "pilotbench" / "traffic" / f"{entry['traffic']}.json"),
                load_json(ROOT / "pilotbench" / "limits" / f"{workload}.json"),
                mine(spec["end_to_end"]), mine(spec["per_layer"]))


def reader(name: str):
    path = ROOT / "pilotbench" / "metrics" / f"{name}.py"
    spec = importlib.util.spec_from_file_location(
        "pilotbench_metric_" + name.replace(".", "_").replace("-", "_"), path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


class FinalRecorder:
    """Records the block sample of every sampled final the executor returns
    (``execute`` and ``execute_batch``), as the program reported it: one
    :class:`check.Sample` a result, with the scan of every table it
    block-sampled."""

    def __init__(self, executor):
        self.ex = executor
        self.samples: List[check.Sample] = []
        self._seen: set = set()
        self._keep_alive: list = []
        self._execute, self._batch = executor.execute, executor.execute_batch
        executor.execute, executor.execute_batch = self._on_execute, self._on_batch

    def _keep(self, res) -> None:
        infos = getattr(res, "sample_infos", None)
        if not infos or id(res) in self._seen:
            return
        finals = tuple(check.Final(table, i.rate, i.sampled_block_ids,
                                   i.n_total_blocks, i.n_sampled_blocks)
                       for table, i in infos.items()
                       if i.method == "block" and i.rate < 1.0)
        if finals:
            self._seen.add(id(res))
            self._keep_alive.append(res)
            self.samples.append(check.Sample(finals))

    def _on_execute(self, plan):
        res = self._execute(plan)
        self._keep(res)
        return res

    def _on_batch(self, plans, on_result=None):
        out = self._batch(plans, on_result=on_result)
        for res in out:
            self._keep(res)
        return out

    def take(self) -> List[check.Sample]:
        out, self.samples = self.samples, []
        self._seen.clear()
        self._keep_alive = []
        return out

    def close(self) -> None:
        del self.ex.execute, self.ex.execute_batch


@dataclasses.dataclass
class Record:
    """One query of the window: its timing and what it delivered."""

    query: Query
    t0: float
    t1: float
    answer: check.Answer
    report: Optional[dict]
    refresh: Optional[int] = None
    spans: list = dataclasses.field(default_factory=list)

    @property
    def wall_s(self) -> float:
        return self.t1 - self.t0


def _answer(q: Query, h, samples: List[check.Sample]) -> check.Answer:
    if h.status != "done":
        return check.Answer(q, None, None, q.guarantee is None, [], error=h.error or h.status)
    a = h.result()
    rep = a.report
    exact = q.guarantee is None or rep.fallback is not None
    # a sample is this answer's where it sampled the tables the plan
    # samples, each at the rate the plan chose for it
    chosen = {} if rep.plan is None else {t: r for t, r in rep.plan.rates.items() if r < 1.0}
    mine = [s for s in samples
            if {f.table: f.rate for f in s.finals} == chosen] if not exact else []
    return check.Answer(q, np.array(a.values, dtype=float), np.array(a.group_present, bool),
                        exact, mine)


def _report(h) -> Optional[dict]:
    rep = h.report
    return None if rep is None else {
        f.name: getattr(rep, f.name) for f in dataclasses.fields(rep)
        if f.name not in ("plan",)}


def _sync(dev) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def forbidden_modules() -> List[str]:
    """Top-level names of ``sys.modules`` that the run must not hold."""
    return sorted({m.split(".", 1)[0] for m in list(sys.modules)} & set(FORBIDDEN))


@dataclasses.dataclass
class Outcome:
    """One run: the result line's object, and what its check read."""

    result: dict
    answers: List[check.Answer]
    reference: check.Reference
    limits: dict


def run_cell(workload: str, seed: int, seconds: float, trace_on: bool, *,
             t_process: float, device: str = "cuda",
             cell: Optional[Cell] = None) -> Outcome:
    """Run one cell once: set-up, the window, the check and the metrics."""
    from repro_torch.api.session import Session, SessionConfig
    from repro_torch.engine.table import BlockTable

    cell = cell or load_cell(workload)
    dev = torch.device(device)
    stamps = [("start-up and imports", time.perf_counter())]
    cfg, mix = cell.config, cell.mix
    br = int(cfg["block_rows"])
    data = tables.make_tables(cfg, seed, dev)
    _sync(dev)
    stamps.append(("tables", time.perf_counter()))
    session = Session(None, seed=seed, device=dev,
                      config=SessionConfig(**mix["session"], tracing=trace_on))
    for t, cols in data.items():
        session.register_table(t, BlockTable(
            name=t, columns=dict(cols), block_rows=br,
            num_rows=int(next(iter(cols.values())).shape[0])),
            **tables.register_options(cfg, t))
    traffic = Traffic(mix, seed)
    mode = traffic.mode
    stamps.append(("session", time.perf_counter()))

    def ask(queries: List[Query]):
        hs = mode.ask(session, queries)
        _sync(dev)
        return hs

    for i, batch in enumerate(traffic.warm()):
        ask(batch)
        if i == 0:
            stamps.append(("first warm-up call", time.perf_counter()))
    _sync(dev)
    stamps.append(("the rest of the warm-up", time.perf_counter()))
    setup_s = stamps[-1][1] - t_process
    prev = t_process
    for name, t in stamps:
        print(f"setup {name}: {t - prev:.3f} s", file=sys.stderr)
        prev = t

    recorder = FinalRecorder(session.executor)
    records: List[Record] = []
    refreshes: List[dict] = []
    batches = traffic.batches()
    # the window runs to its deadline, and at least the mode's least number
    # of batches, so that every query the mix can ask is compared
    min_batches = mode.min_batches(traffic)
    tracer = trace.DeviceTrace() if trace_on and dev.type == "cuda" else None
    if tracer is not None:
        tracer.__enter__()
    t_begin = time.perf_counter()
    deadline = t_begin + seconds
    n_batches = 0
    try:
        while True:
            queries = next(batches)
            t0 = time.perf_counter()
            hs = ask(queries)
            t1 = time.perf_counter()
            n_batches += 1
            samples = recorder.take()
            stats = mode.stats(session)
            k = None if stats is None else len(refreshes)
            for q, h in zip(queries, hs):
                # a mode that times its queries itself returns (handle, t0, t1)
                h, q0, q1 = h if isinstance(h, tuple) else (h, t0, t1)
                rec = Record(q, q0, q1, _answer(q, h, samples), _report(h), k)
                if trace_on:
                    rec.spans = trace.flatten_spans(h.trace(), h.t_submit)
                records.append(rec)
            if stats is not None:
                refreshes.append(dict(stats, t0=t0, t1=t1))
            if t1 >= deadline and n_batches >= min_batches:
                break
    finally:
        if tracer is not None:
            tracer.__exit__(*sys.exc_info())
    t_end = records[-1].t1
    window_s = t_end - t_begin

    peak = int(torch.cuda.max_memory_allocated(dev)) if dev.type == "cuda" else 0
    recorder.close()
    session.close()
    del session, recorder
    gc.collect()
    if dev.type == "cuda":
        torch.cuda.empty_cache()

    ref = check.Reference(data, br)
    answers = [r.answer for r in records]
    checks = check.judge(answers, ref, cell.limits)
    failed = sum(a.error is not None for a in answers)
    correct = check.passed(checks) and failed == 0

    dev_trace = None
    if tracer is not None and tracer.aligned:
        busy, gaps = trace.union_busy(tracer.ops, t_begin, t_end)
        spans = [s for r in records for s in r.spans]
        dev_trace = SimpleNamespace(
            ops=[o for o in tracer.ops if t_begin <= o.start_s <= t_end],
            busy_s=busy, window_s=window_s, gaps=gaps,
            device_ops=trace.top_ops([o for o in tracer.ops
                                      if t_begin <= o.start_s <= t_end]),
            idle_gaps=trace.label_gaps(gaps, spans))
    kind = torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu"
    ctx = SimpleNamespace(workload=workload, config=cfg, mix=mix, seed=seed,
                          setup_s=setup_s, window_s=window_s, records=records,
                          refreshes=refreshes, trace=dev_trace, device_kind=kind,
                          reference=ref)
    metrics: Dict[str, dict] = {}
    for m in (cell.per_layer if trace_on else cell.end_to_end):
        v = reader(m["name"])(ctx)
        if v is not None:
            metrics[m["name"]] = {"value": float(v), "unit": m["unit"]}

    result = {"correct": bool(correct), "attempted": len(records), "failed": failed,
              "metrics": metrics,
              "device": {"platform": "gpu" if dev.type == "cuda" else dev.type,
                         "kind": kind, "count": 1, "memory_peak_bytes": peak}}
    if trace_on and dev_trace is not None:
        result["device"]["busy_s"] = dev_trace.busy_s
        result["device"]["window_s"] = dev_trace.window_s
        result["breakdown"] = {"device_ops": dev_trace.device_ops,
                               "idle_gaps": dev_trace.idle_gaps}
    result["checks"] = checks
    return Outcome(result, answers, ref, cell.limits)
