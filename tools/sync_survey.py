#!/usr/bin/env python3
"""List every host synchronization of a few queries of each benchmark cell,
and check that each lies inside a ``host_read`` span, on one CUDA card.

    python3 tools/sync_survey.py [--cells NAME ...] [--seed N] [--out FILE]
    python3 tools/sync_survey.py --device cpu --rows 320000   # a rehearsal

For each cell of ``BENCHMARK.json`` (``pilotbench``'s tables, session
settings and traffic) the survey asks the cell's first queries (a sql cell's
first three, a refresh cell's first refresh) once to build what they use,
then asks them again with ``torch.cuda.set_sync_debug_mode("warn")`` and
tracing on.  Every warning that mode raises is one synchronization: its
stack (the port's and the harness's frames) and whether a ``host_read`` span
of the active trace was open on the thread.  Three shapes no cell runs
follow at the first cell's scale: Q6 on the column-kernel route, the fused
program and a staged ladder.  Prints, a batch a line, (syncs, ``host_read``
spans, syncs outside a span), and writes every site as JSON to ``--out``.
On the CPU nothing synchronizes; the rehearsal runs the same paths at
``--rows`` rows.
"""

import argparse
import json
import os
import sys
import threading
import traceback
import warnings
from collections import Counter

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path[:0] = [ROOT, os.path.join(ROOT, "src")]

CELLS = ("tpch_sf10.q6_approx", "tpch_sf10.q1_approx", "tpch_sf100.q1_exact",
         "tpch_sf10.dashboard_refresh")


def _spans(tree, name):
    todo, n = [tree["root"]] if tree else [], 0
    while todo:
        sp = todo.pop()
        n += sp["name"] == name
        todo.extend(sp.get("children", ()))
    return n


class Survey:
    """Collects the synchronization warnings raised while it is entered."""

    def __init__(self, cuda: bool):
        self.cuda = cuda
        self.events = []

    def _hook(self, message, category, filename, lineno, file=None, line=None):
        from repro_torch.obs import trace as _trace
        if "synchroniz" not in str(message):
            return
        frames = traceback.extract_stack()[:-1]
        stack = [f"{os.path.relpath(f.filename, ROOT)}:{f.lineno} {f.name}" for f in frames
                 if "repro_torch" in f.filename or "pilotbench" in f.filename]
        tr = _trace.active()
        open_ = tr._stacks.get(threading.get_ident(), []) if tr is not None else []
        self.events.append({"stack": stack[-6:] or [f"{f.filename}:{f.lineno}" for f in frames[-3:]],
                            "in_host_read": any(s.name == "host_read" for s in open_)})

    def run(self, ask):
        import torch
        self.events = []
        with warnings.catch_warnings():
            warnings.simplefilter("always")
            warnings.showwarning = self._hook
            if self.cuda:
                torch.cuda.set_sync_debug_mode("warn")
            try:
                handles = ask()
            finally:
                if self.cuda:
                    torch.cuda.set_sync_debug_mode("default")
        reads = sum(_spans(h.trace(), "host_read") for h in handles)
        return {"queries": len(handles), "syncs": len(self.events), "host_read_spans": reads,
                "outside_host_read": sum(not e["in_host_read"] for e in self.events),
                "statuses": [h.status for h in handles],
                "sites": Counter(" <- ".join(reversed(e["stack"][-3:]))
                                 for e in self.events).most_common(),
                "outside": [e for e in self.events if not e["in_host_read"]]}


def session_for(config, mix_session, data, dev, seed, **register):
    from pilotbench import tables
    from repro_torch.api.session import Session, SessionConfig
    from repro_torch.engine.table import BlockTable
    s = Session(None, seed=seed, device=dev, config=SessionConfig(**mix_session, tracing=True))
    for t, cols in data.items():
        s.register_table(t, BlockTable(name=t, columns=dict(cols),
                                       block_rows=int(config["block_rows"]),
                                       num_rows=int(next(iter(cols.values())).shape[0])),
                         **{**tables.register_options(config, t), **register})
    return s


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--cells", nargs="*", default=list(CELLS))
    ap.add_argument("--seed", type=int, default=3400000777)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--rows", type=int, default=0, help="lineitem rows (default: the cell's)")
    ap.add_argument("--out", default=os.path.join(ROOT, "chiprun_out", "sync_survey.json"))
    args = ap.parse_args(argv)

    import torch
    from pilotbench import harness, tables
    from pilotbench.reference import tpch_days
    from pilotbench.traffic import Traffic

    dev = torch.device(args.device)
    cuda = dev.type == "cuda"
    if cuda and not torch.cuda.is_available():
        print("sync_survey: no CUDA device", file=sys.stderr)
        return 2
    survey = Survey(cuda)
    out = {"device": torch.cuda.get_device_name(dev) if cuda else "cpu",
           "torch": torch.__version__, "cells": {}}

    def config_of(workload):
        cell = harness.load_cell(workload)
        cfg = dict(cell.config, lineitem_rows=args.rows) if args.rows else cell.config
        return cell, cfg

    def report(label, runs):
        out["cells"][label] = runs
        print(label, [(r["syncs"], r["host_read_spans"], r["outside_host_read"]) for r in runs],
              flush=True)

    for w in args.cells:
        cell, cfg = config_of(w)
        data = tables.make_tables(cfg, args.seed, dev)
        s = session_for(cfg, cell.mix["session"], data, dev, args.seed)
        traffic = Traffic(cell.mix, args.seed)
        batches = traffic.warm()[:3] if cell.mix["mode"] == "sql" else traffic.warm()[:1]
        for b in batches:
            traffic.mode.ask(s, b)
        report(w, [survey.run(lambda b=b: traffic.mode.ask(s, b)) for b in batches])
        s.close()
        del s, data

    cell, cfg = config_of(CELLS[0])
    data = tables.make_tables(cfg, args.seed, dev)
    q6 = ("SELECT SUM(l_extendedprice * l_discount) AS revenue FROM lineitem WHERE {dates} "
          "AND l_discount BETWEEN 0.05 AND 0.07 AND l_quantity < {q} ERROR 5% CONFIDENCE 95%")
    one_strict = q6.replace("{dates}", f"l_shipdate BETWEEN {tpch_days(1994)} AND {tpch_days(1995) - 1}")
    two_strict = q6.replace("{dates}", f"l_shipdate >= {tpch_days(1995)} AND l_shipdate < {tpch_days(1996)}")
    plain = {"async_workers": 0, "pilot_workers": 0, "result_cache_size": 0}
    for label, settings, register, sql in (
            ("shape.kernel_route", plain, {}, one_strict),
            ("shape.fused", dict(plain, fused_taqa=True), {}, one_strict),
            ("shape.staged", plain, {"staged_rates": True}, two_strict)):
        s = session_for(cfg, settings, data, dev, args.seed, **register)
        for q in (24, 25):
            s.sql(sql.format(q=q))
        report(label, [survey.run(lambda q=q: [s.sql(sql.format(q=q))]) for q in (24, 25, 23)])
        s.close()

    os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
    with open(args.out, "w") as f:
        json.dump(out, f, indent=1)
    print("wrote", args.out, "on", out["device"])
    return 0


if __name__ == "__main__":
    sys.exit(main())
