#!/usr/bin/env python3
"""Sharded tables spread over every card, checked and timed on four H100s.

    python3 tools/shard_cards.py                     # 4 cards: SF10, then SF100
    python3 tools/shard_cards.py --big-rows 0        # SF10 only
    python3 tools/shard_cards.py --device cpu --rows 400000 --big-rows 800000
                                                     # a CPU rehearsal

One process.  ``Session.register_table(..., shards=N)`` places shard i on
``cuda:{i % k}`` over the k visible cards (``dist.shard.default_devices``,
as the reference places shards over ``jax.devices()``); the pinned session
registers with that function standing in for every shard on card 0
(:func:`placed_on`), so both go through the session's own path.  No collective is needed: each shard's sums cross to the host, where
they merge in f64.  On the CPU the "cards" are ``--cards`` copies of the
CPU device, so the spread path runs with every copy a no-op.

(a) ``--rows`` (SF10 lineitem: 60M rows, 1,875,000 blocks of 32) from
``tpch_catalog(seed=--data-seed)`` on card 0, session seed ``--seed``,
result cache off.  Sessions: monolithic ("plain"); ``shards=4`` pinned to
card 0; ``shards=4``, 8 and 7 by default (one shard a card, two, uneven);
each sharded one and the monolithic one again with ``staged_rates=True``.
Each answers Q6, SUM/COUNT and the grouped Q1 at ERROR 5% CONFIDENCE 95%,
runs each query's pilot at one pilot seed (``PilotDB.run_pilot``), and
drains ``chip_smoke.py`` phase 6's herd.  Checks: within the fresh
sessions and within the staged ones (a ladder draws under its pinned
seed), answers, pilot block sums and herd answers bitwise equal across
every placement and shard count; sharded answers within rtol 1e-5 of the
monolithic session's; every answer within 5% of exact or a stated
fallback; each herd answer bitwise its ``Session.sql``.  Also the sharded
join pilot at ``--join-rows`` (``tests/test_torch_cuda.py``'s size), 4 and
8 shards over the cards, bitwise the one-card merge and the monolithic
pilot.  Printed per card: shard bytes (views on card 0), replicated
bytes, staged rung bytes, peak memory, launches by kernel.

(b) ``--big-rows`` (SF100: 600M rows, 18,750,000 blocks): the same
sessions but the staged 8 and 7, and the same checks; then ``shards=4``
pinned against spread, median of ``--runs`` warm runs in turns, every card
synchronized inside the clock, split into pilot / rate solve / final, the
exact queries too; each card's busy time, idle share and overlap under
``torch.profiler``; the host draw at the pilot's rate.  The join is left
out at this size (its dense pair tensor grows as n_phys x N_right).

Exits non-zero on any failed check; writes every number as one JSON object
to ``--out`` (``build/shard_cards.json``) and ends with the card's name and
power limit.  Peak memory is each card's peak over what it held when the
session registered.
"""

from __future__ import annotations

import argparse
import contextlib
import gc
import json
import os
import statistics
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(ROOT, "src"))

BLOCK_ROWS = 32
Q6 = ("SELECT SUM(l_extendedprice * l_discount) AS revenue FROM lineitem "
      "WHERE l_shipdate BETWEEN 100 AND 1500 AND l_discount BETWEEN 0.02 AND 0.08")
SUM_COUNT = "SELECT SUM(l_extendedprice) AS s, COUNT(*) AS n FROM lineitem"
Q1 = ("SELECT SUM(l_quantity) AS qty, SUM(l_extendedprice) AS price, COUNT(*) AS n "
      "FROM lineitem WHERE l_shipdate < 2200 GROUP BY l_returnflag")
QUERIES = {"q6": Q6, "sum_count": SUM_COUNT, "q1": Q1}
GUARANTEE = " ERROR 5% CONFIDENCE 95%"
HERD = ([f"SELECT SUM(l_extendedprice * l_discount) AS revenue FROM lineitem "
         f"WHERE l_shipdate BETWEEN {100 + 50 * i} AND {1500 + 30 * i} AND "
         f"l_discount BETWEEN 0.02 AND 0.08" + GUARANTEE for i in range(8)]
        + [SUM_COUNT + f" ERROR {e}% CONFIDENCE 95%" for e in (5, 6, 7, 8)])
PILOT_SEED = 7
KERNELS = ("filtered_agg", "filtered_agg_batched", "block_agg", "block_agg_batched",
           "segment_sum")
FAILED = []


def check(cond, msg):
    if not cond:
        FAILED.append(msg)
        print(f"[FAIL] {msg}", flush=True)


def same_bits(np, a, b):
    if a is None or b is None:
        return a is None and b is None
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return a.shape == b.shape and np.array_equal(a.view(np.int64), b.view(np.int64))


def nvidia_smi_line():
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
            capture_output=True, text=True, timeout=60, check=True)
        return out.stdout.strip().splitlines()[0]
    except (OSError, subprocess.SubprocessError):
        return "nvidia-smi not available"


class CardCounter:
    """Stands in for the column kernels and ``segment_sum`` where the
    physical layer looks them up, counting calls by the card of their first
    tensor; every call passes through to the wrapper."""

    def __init__(self, physical):
        self.counts = {}
        self.wrappers = [getattr(physical, name) for name in KERNELS]
        for fn in self.wrappers:
            setattr(physical, fn.__name__, self._wrap(fn))

    def launches(self):
        """Each wrapper's own count of its card launches."""
        return {fn.__name__: fn.launches for fn in self.wrappers}

    def _wrap(self, fn):
        name = fn.__name__

        def counted(*args, **kwargs):
            dev = str(args[0].device)
            self.counts.setdefault(dev, {}).setdefault(name, 0)
            self.counts[dev][name] += 1
            return fn(*args, **kwargs)
        counted.__name__ = name
        return counted

    def take(self):
        out, self.counts = self.counts, {}
        return out


def sync_all(torch, cards):
    if cards[0].type == "cuda":
        for c in cards:
            torch.cuda.synchronize(c)


def table_bytes(t):
    """Every tensor of a BlockTable: columns, valid (1 B a row), block_id (4)."""
    return t.padded_rows * (t.row_bytes() + 5)


def placement(s, li_device):
    """Per card: bytes of shards that are views of the table, shard copies,
    replicated tables and staged rung parts."""
    ex = s.executor
    out = {}

    def add(dev, key, n):
        d = out.setdefault(str(dev), {"shard_views": 0, "shard_copies": 0,
                                      "replicated": 0, "staged": 0})
        d[key] += n
    sharded = ex._sharded.get("lineitem")
    if sharded is None:
        return out
    seen = set()
    for shard, sub in zip(sharded.shards, ex._shard_executors["lineitem"]):
        dev = shard.table.device
        add(dev, "shard_views" if dev == li_device else "shard_copies",
            table_bytes(shard.table))
        for name, t in sub.catalog.items():
            if name != "lineitem" and t.device != li_device and id(t) not in seen:
                seen.add(id(t))
                add(dev, "replicated", table_bytes(t))
    lad = ex.staged.ladder("lineitem")
    for rung in (lad.rungs if lad is not None else []):
        for part in rung.parts or []:
            if part.table is not None:
                add(part.table.device, "staged", table_bytes(part.table))
    return out


@contextlib.contextmanager
def placed_on(devices):
    """While a session registers, ``dist.shard.default_devices`` returns
    ``devices`` (None: the default itself)."""
    from repro_torch.dist import shard
    default = shard.default_devices
    if devices is not None:
        shard.default_devices = lambda table: list(devices)
    try:
        yield
    finally:
        shard.default_devices = default


def run_session(torch, np, Session, SessionConfig, cat, tag, cards, counter, kw, device):
    """Register, answer, pilot, drain: one session's results.  ``kw`` is
    ``register_table``'s keywords, with ``devices`` for :func:`placed_on`."""
    devices = kw.get("devices")
    register = {k: v for k, v in kw.items() if k != "devices"}
    li = cat["lineitem"]
    gc.collect()
    if device == "cuda":
        torch.cuda.empty_cache()
        for c in cards:
            torch.cuda.reset_peak_memory_stats(c)
        mem0 = [torch.cuda.memory_allocated(c) for c in cards]
    sync_all(torch, cards)
    t0 = time.perf_counter()
    s = Session(seed=ARGS.seed, device=device, config=SessionConfig(result_cache_size=0))
    s.register_table("orders", cat["orders"])
    with placed_on(devices):
        s.register_table("lineitem", li, **register)
    sync_all(torch, cards)
    reg_s = time.perf_counter() - t0
    if kw.get("shards"):
        on = devices or cards
        want = [str(on[i % len(on)]) for i in range(kw["shards"])]
        got = [str(sh.table.device) for sh in s.executor._sharded["lineitem"].shards]
        check(got == want, f"{tag}: shards on {got}, not {want}")
    out = {"register_s": reg_s, "answers": {}, "fallbacks": {}, "rates": {},
           "pilots": {}, "placement": placement(s, li.device)}
    counter.take()
    before = counter.launches()
    for qn, sql in QUERIES.items():
        h = s.sql(sql + GUARANTEE)
        check(h.status == "done", f"{tag} {qn}: {h.error}")
        out["answers"][qn] = h
        out["fallbacks"][qn] = h.fallback
        out["rates"][qn] = None if h.report.plan is None else dict(h.report.plan.rates)
    out["launches"] = counter.take()
    if device == "cuda":
        # every call counted by card was one launch of the wrapper's kernel
        after = counter.launches()
        for name in KERNELS:
            calls = sum(c.get(name, 0) for c in out["launches"].values())
            check(after[name] - before[name] == calls,
                  f"{tag}: {name} made {calls} calls, {after[name] - before[name]} launches")
        for c in cards:
            if kw.get("shards") and (devices is None or c in devices):
                check(str(c) in out["launches"], f"{tag}: no kernel ran on {c}")
    for qn, h in out["answers"].items():
        pilot = s.db.run_pilot(h.query, h.spec, PILOT_SEED).pilot
        out["pilots"][qn] = None if pilot is None else pilot.block_sums
    hs = [s.submit(q) for q in HERD]
    s.drain()
    out["herd_launches"] = counter.take()
    herd = []
    for h in hs:
        check(h.status == "done", f"{tag} herd: {h.error}")
        r = s.sql(h.sql)
        check(same_bits(np, h.answer.values, r.answer.values),
              f"{tag}: a herd answer is not bitwise its Session.sql: {h.sql}")
        herd.append(h.answer.values)
    out["herd"] = herd
    counter.take()
    if device == "cuda":
        sync_all(torch, cards)
        out["device_gb"] = {str(c): (torch.cuda.memory_allocated(c) - m0) / 1e9
                            for c, m0 in zip(cards, mem0)}
        # the peak over what the card held before this session registered
        out["peak_gb"] = {str(c): (torch.cuda.max_memory_allocated(c) - m0) / 1e9
                          for c, m0 in zip(cards, mem0)}
    print(f"[{tag}] registered in {reg_s:.3f} s; placement (bytes) {out['placement']}; "
          f"device allocation (GB) {out.get('device_gb')}; peak (GB) "
          f"{out.get('peak_gb')}; launches by card {out['launches']}; herd launches "
          f"{out['herd_launches']}; fallbacks {out['fallbacks']}; rates {out['rates']}",
          flush=True)
    return s, out


def compare(np, runs, exact, fresh, staged, what):
    """The checks over one size's sessions."""
    for group, mono in ((fresh, "plain"), (staged, "plain+staged")):
        first = group[0]
        for tag in group:
            for qn in QUERIES:
                a, b = runs[tag], runs[first]
                check(same_bits(np, a["answers"][qn].answer.values,
                                b["answers"][qn].answer.values),
                      f"{what} {qn}: {tag} differs from {first}")
                check(same_bits(np, a["pilots"][qn], b["pilots"][qn]),
                      f"{what} {qn}: {tag}'s pilot block sums differ from {first}'s")
                m = runs[mono]["answers"][qn]
                check(a["fallbacks"][qn] == runs[mono]["fallbacks"][qn],
                      f"{what} {qn}: {tag} falls back differently from {mono}")
                if not np.allclose(a["answers"][qn].answer.values, m.answer.values,
                                   rtol=1e-5, atol=0):
                    check(False, f"{what} {qn}: {tag} beyond rtol 1e-5 of {mono}")
            for i, (x, y) in enumerate(zip(runs[tag]["herd"], runs[first]["herd"])):
                check(same_bits(np, x, y), f"{what} herd {i}: {tag} differs from {first}")
    for tag, r in runs.items():
        for qn, h in r["answers"].items():
            e = exact[qn]
            present = e.answer.group_present
            rel = np.abs(h.answer.values[:, present] - e.answer.values[:, present]) \
                / np.abs(e.answer.values[:, present])
            check(bool(np.all(rel <= 0.05)) or h.fallback is not None,
                  f"{what} {tag} {qn}: error {rel.ravel()} above 5% without a fallback")
    print(f"[{what}] bitwise across {fresh} and across {staged} (answers, pilot block "
          "sums, herd); sharded within rtol 1e-5 of the monolithic sessions; every "
          "answer within 5% of exact or a fallback", flush=True)


def join_pilots(torch, np, cards, device):
    """The sharded join pilot's pair sums, 4 and 8 shards over the cards,
    against the same shards on card 0 and the monolithic pilot."""
    from repro_torch.dist import DistExecutor
    from repro_torch.engine import logical as L
    from repro_torch.engine.datagen import tpch_catalog
    from repro_torch.engine.executor import Executor
    from repro_torch.engine.expr import Col
    cat = tpch_catalog(ARGS.join_rows, BLOCK_ROWS, seed=0, device=cards[0])
    plan = L.Aggregate(
        child=L.Join(L.Scan("lineitem"), L.Scan("orders"), "l_orderkey", "o_orderkey"),
        aggs=(L.AggSpec("sum", Col("l_extendedprice"), "rev"),))
    ref = Executor(dict(cat), device=cards[0]).execute_pilot(
        plan, "lineitem", 0.05, 11, pair_tables=("orders",))
    out = {}
    for n in (4, 8):
        for where, devices in (("one card", [cards[0]]), ("spread", spread(cards))):
            ex = DistExecutor(dict(cat), device=cards[0])
            st = ex.register_sharded("lineitem", cat["lineitem"], n, devices=devices)
            ps = ex.execute_pilot(plan, "lineitem", 0.05, 11, pair_tables=("orders",))
            check(ps.n_sampled_blocks == ref.n_sampled_blocks > 0,
                  f"join {n} shards {where}: {ps.n_sampled_blocks} sampled blocks")
            check(same_bits(np, ps.block_sums, ref.block_sums),
                  f"join {n} shards {where}: block sums differ from the monolithic pilot")
            check(same_bits(np, ps.pair_sums["orders"], ref.pair_sums["orders"]),
                  f"join {n} shards {where}: pair sums differ from the monolithic pilot")
            out[f"{n} {where}"] = sorted({str(s.table.device) for s in st.shards})
    print(f"[join] pair-sum pilots at {ARGS.join_rows:,} rows, 4 and 8 shards on one card "
          f"and spread over {out}: bitwise the monolithic pilot ({ref.n_sampled_blocks} "
          "sampled blocks)", flush=True)
    return out


def spread(cards):
    """The devices of the default placement: None on the card (every
    visible card), the CPU copies in a rehearsal."""
    return None if cards[0].type == "cuda" else list(cards)


def intervals_by_card(prof):
    from torch.autograd import DeviceType
    out = {}
    for ev in prof.events():
        if ev.device_type == DeviceType.CUDA:
            out.setdefault(ev.device_index, []).append(
                (ev.time_range.start, ev.time_range.end))
    return out


def union(iv):
    merged = []
    for a, b in sorted(iv):
        if merged and a <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], b)
        else:
            merged.append([a, b])
    return merged


def profile_query(torch, s, sql, cards):
    """One warm run under torch.profiler: wall, and per card its busy
    time, first and last kernel; the time two or more cards were busy."""
    from torch.profiler import ProfilerActivity, profile
    acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if cards[0].type == "cuda" else [])
    with profile(activities=acts) as prof:
        sync_all(torch, cards)
        t0 = time.perf_counter()
        s.sql(sql)
        sync_all(torch, cards)
        wall_ms = (time.perf_counter() - t0) * 1e3
    by_card = {k: union(v) for k, v in intervals_by_card(prof).items()}
    cards_out = {}
    for k, iv in sorted(by_card.items()):
        busy = sum(b - a for a, b in iv) / 1e3
        cards_out[f"cuda:{k}"] = {"busy_ms": busy, "idle_share": 1 - busy / wall_ms,
                                  "first_us": iv[0][0], "last_us": iv[-1][1],
                                  "kernels": len(iv)}
    edges = sorted([(a, 1) for iv in by_card.values() for a, _ in iv]
                   + [(b, -1) for iv in by_card.values() for _, b in iv])
    both, live, last = 0.0, 0, None
    for t, d in edges:
        if live >= 2:
            both += t - last
        live, last = live + d, t
    return {"wall_ms": wall_ms, "cards": cards_out,
            "overlap_ms": both / 1e3 if by_card else None}


def timed(torch, s, sql, cards):
    sync_all(torch, cards)
    t0 = time.perf_counter()
    h = s.sql(sql)
    sync_all(torch, cards)
    wall = (time.perf_counter() - t0) * 1e3
    check(h.status == "done", f"timed query failed: {h.error}")
    r = h.report
    return {"wall": wall, "pilot": (r.pilot_time_s or 0) * 1e3,
            "rate_solve": (r.plan_time_s or 0) * 1e3, "final": (r.final_time_s or 0) * 1e3}


def timing(torch, np, sessions, cards, li, smi):
    """Pinned against spread, in turns; each card's busy time; the draw."""
    from repro_torch.engine.sampling import draw_block_ids
    out = {}
    for qn, sql in QUERIES.items():
        for exact in (False, True):
            q = sql if exact else sql + GUARANTEE
            runs = {tag: [] for tag in sessions}
            for tag, s in sessions.items():
                s.sql(q)
            for _ in range(ARGS.runs):
                for tag, s in sessions.items():
                    runs[tag].append(timed(torch, s, q, cards))
            for tag, s in sessions.items():
                med = {k: statistics.median(r[k] for r in runs[tag]) for k in runs[tag][0]}
                med["walls"] = [r["wall"] for r in runs[tag]]
                med["profile"] = profile_query(torch, s, q, cards)
                key = f"{tag} {qn}{' exact' if exact else ''}"
                out[key] = med
                p = med["profile"]
                print(f"[time] {key}: {med['wall']:.2f} ms = pilot {med['pilot']:.2f} + "
                      f"rate solve {med['rate_solve']:.2f} + final {med['final']:.2f} "
                      f"(median of {ARGS.runs} in turns; walls "
                      f"{[round(w, 2) for w in med['walls']]}); profiled wall "
                      f"{p['wall_ms']:.2f} ms, cards {p['cards'] or 'not measured'}, "
                      f"two or more cards busy {p['overlap_ms']} ms  [{smi}]", flush=True)
    some = next(iter(sessions.values()))
    theta = some.sql(Q6 + GUARANTEE).report.theta_pilot
    draws = []
    for _ in range(ARGS.runs):
        t0 = time.perf_counter()
        draw_block_ids(li.num_blocks, theta, 1)
        draws.append((time.perf_counter() - t0) * 1e3)
    out["draw_ms"] = {"theta": theta, "blocks": li.num_blocks,
                      "median": statistics.median(draws), "runs": draws}
    print(f"[time] the host draw at theta {theta:.6g} over {li.num_blocks:,} blocks: "
          f"{statistics.median(draws):.3f} ms (median of {ARGS.runs})", flush=True)
    return out


def one_size(torch, np, rows, what, cards, counter, device, smi, big):
    from repro_torch.api import Session, SessionConfig
    from repro_torch.engine.datagen import tpch_catalog
    t0 = time.perf_counter()
    cat = tpch_catalog(rows, BLOCK_ROWS, seed=ARGS.data_seed, device=cards[0])
    sync_all(torch, cards)
    li = cat["lineitem"]
    print(f"[{what}] tpch_catalog({rows:,}, {BLOCK_ROWS}, seed={ARGS.data_seed}) on "
          f"{cards[0]}: {li.num_blocks:,} blocks, lineitem {table_bytes(li):,} B, orders "
          f"{table_bytes(cat['orders']):,} B, in {time.perf_counter() - t0:.1f} s", flush=True)
    one = [cards[0]]
    fresh = {"shards=4 pinned": {"shards": 4, "devices": one},
             "shards=4": {"shards": 4, "devices": spread(cards)},
             "shards=8": {"shards": 8, "devices": spread(cards)},
             "shards=7": {"shards": 7, "devices": spread(cards)}}
    staged = {f"{k}+staged": dict(v, staged_rates=True) for k, v in fresh.items()
              if not big or k in ("shards=4 pinned", "shards=4")}
    runs, keep = {}, {}
    plain, runs["plain"] = run_session(torch, np, Session, SessionConfig, cat,
                                       f"{what} plain", cards, counter, {}, device)
    exact = {qn: plain.sql(sql) for qn, sql in QUERIES.items()}
    for tag, kw in [("plain+staged", {"staged_rates": True}), *fresh.items(), *staged.items()]:
        s, runs[tag] = run_session(torch, np, Session, SessionConfig, cat, f"{what} {tag}",
                                   cards, counter, kw, device)
        if big and tag in ("shards=4 pinned", "shards=4"):
            keep[tag] = s
        else:
            s.close()
        del s
    compare(np, runs, exact, list(fresh), list(staged), what)
    out = {"rows": rows, "blocks": li.num_blocks, "lineitem_bytes": table_bytes(li),
           "sessions": {tag: {k: v for k, v in r.items()
                              if k not in ("answers", "pilots", "herd")}
                        for tag, r in runs.items()}}
    if big:
        out["timing"] = timing(torch, np, {"one card": keep["shards=4 pinned"],
                                           "four cards": keep["shards=4"]}, cards, li, smi)
    for s in (plain, *keep.values()):
        s.close()
    del cat, li, plain, keep, runs, exact
    gc.collect()
    if device == "cuda":
        torch.cuda.empty_cache()
    return out


def main() -> int:
    global ARGS
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    p.add_argument("--cards", type=int, default=4,
                   help="cards the machine must have (CUDA); CPU copies in a rehearsal")
    p.add_argument("--rows", type=int, default=60_000_000)
    p.add_argument("--big-rows", type=int, default=600_000_000, help="0 skips part (b)")
    p.add_argument("--join-rows", type=int, default=40_000)
    p.add_argument("--runs", type=int, default=5)
    p.add_argument("--seed", type=int, default=42, help="the sessions' seed")
    p.add_argument("--data-seed", type=int, default=0)
    p.add_argument("--out", default=os.path.join(ROOT, "build", "shard_cards.json"))
    ARGS = p.parse_args()

    import numpy as np
    import torch

    from repro_torch.engine import physical

    if ARGS.device == "cuda":
        if not torch.cuda.is_available():
            print("no CUDA card", file=sys.stderr)
            return 2
        if torch.cuda.device_count() != ARGS.cards:
            print(f"needs {ARGS.cards} cards, sees {torch.cuda.device_count()}",
                  file=sys.stderr)
            return 2
        from repro_torch.kernels import _build
        t0 = time.perf_counter()
        _build.build(["filtered_agg", "block_agg", "segment_sum"])
        print(f"[build] filtered_agg, block_agg, segment_sum in "
              f"{time.perf_counter() - t0:.1f} s", flush=True)
        cards = [torch.device("cuda", i) for i in range(ARGS.cards)]
    else:
        cards = [torch.device("cpu")] * ARGS.cards
    smi = nvidia_smi_line() if ARGS.device == "cuda" else "cpu"
    print(f"[main] {ARGS.device} x {ARGS.cards}: torch {torch.__version__}; {smi}", flush=True)
    counter = CardCounter(physical)
    t0 = time.perf_counter()
    result = {"device": smi, "cards": ARGS.cards, "torch": torch.__version__,
              "join": join_pilots(torch, np, cards, ARGS.device)}
    result["sf10"] = one_size(torch, np, ARGS.rows, "a", cards, counter, ARGS.device, smi, False)
    if ARGS.big_rows:
        result["sf100"] = one_size(torch, np, ARGS.big_rows, "b", cards, counter,
                                   ARGS.device, smi, True)
    result["seconds"] = time.perf_counter() - t0
    result["failed"] = FAILED
    os.makedirs(os.path.dirname(ARGS.out), exist_ok=True)
    with open(ARGS.out, "w") as f:
        json.dump(result, f, default=str, indent=1)
    print(f"[main] {len(FAILED)} failed checks in {result['seconds']:.1f} s; "
          f"results in {ARGS.out}")
    print(smi)
    return 1 if FAILED else 0


if __name__ == "__main__":
    sys.exit(main())
