"""The device trace of a ``--trace 1`` run: ``torch.profiler`` over the
measured window, reduced to device intervals on the host's clock.

Only CUDA activity is recorded, so the profiler adds no per-op host work.
A marker kernel (``torch.cuda._sleep``) launched right after a synchronize
at a known host time ties the trace's clock to ``time.perf_counter``, so
the idle gaps between device operations can be labelled by the program's
own spans (``SessionConfig(tracing=True)``) that were open at the time.
"""

from __future__ import annotations

import dataclasses
import json
import os
import tempfile
import time
from collections import defaultdict
from typing import Dict, List, Optional, Sequence, Tuple

import torch

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
MARKER = "spin"          # the kernel of torch.cuda._sleep


@dataclasses.dataclass
class DeviceOp:
    name: str
    cat: str
    start_s: float       # perf_counter seconds
    dur_s: float


def _drop_balanced(s: str, open_: str, close: str) -> str:
    out, depth = [], 0
    for ch in s:
        if ch == open_:
            depth += 1
        elif ch == close and depth:
            depth -= 1
        elif not depth:
            out.append(ch)
    return "".join(out)


def short_name(name: str) -> str:
    """A kernel's qualified name without ``void``, template arguments and
    its parameter list."""
    n = name[5:] if name.startswith("void ") else name
    if n.endswith(")"):                      # the parameter list
        depth = 0
        for i in range(len(n) - 1, -1, -1):
            depth += {")": 1, "(": -1}.get(n[i], 0)
            if depth == 0:
                n = n[:i]
                break
    return _drop_balanced(n, "<", ">").strip()


class DeviceTrace:
    """Context manager around the window: profiles the device only."""

    def __init__(self):
        self.ops: List[DeviceOp] = []
        self.aligned = False

    def __enter__(self):
        from torch.profiler import ProfilerActivity, profile
        self._prof = profile(activities=[ProfilerActivity.CUDA])
        self._prof.__enter__()
        torch.cuda.synchronize()
        self._t_mark = time.perf_counter()
        torch.cuda._sleep(1000)
        torch.cuda.synchronize()
        return self

    def __exit__(self, *exc):
        torch.cuda.synchronize()
        self._prof.__exit__(*exc)
        if exc[0] is None:
            self._read()
        return False

    def _read(self) -> None:
        fd, path = tempfile.mkstemp(suffix=".json")
        os.close(fd)
        try:
            self._prof.export_chrome_trace(path)
            with open(path) as f:
                events = json.load(f)
        finally:
            os.unlink(path)
        if isinstance(events, dict):
            events = events.get("traceEvents", [])
        dev = [e for e in events if e.get("ph") == "X"
               and e.get("cat") in DEVICE_CATS and "dur" in e]
        dev.sort(key=lambda e: float(e["ts"]))
        marker = next((e for e in dev if MARKER in e.get("name", "")), None)
        if marker is None:
            return
        self.aligned = True
        base = float(marker["ts"])
        for e in dev:
            if e is marker:
                continue
            self.ops.append(DeviceOp(
                e.get("name", "?"), e["cat"],
                self._t_mark + (float(e["ts"]) - base) / 1e6,
                float(e["dur"]) / 1e6))


def union_busy(ops: Sequence[DeviceOp], t0: float, t1: float) -> Tuple[float, List[Tuple[float, float]]]:
    """Seconds of [t0, t1] in which some device operation ran, and the idle
    gaps of [t0, t1] between them."""
    spans = sorted((max(o.start_s, t0), min(o.start_s + o.dur_s, t1))
                   for o in ops)
    busy, gaps, cur = 0.0, [], t0
    for a, b in spans:
        if b <= a:
            continue
        if a > cur:
            gaps.append((cur, a))
        if b > cur:
            busy += b - max(a, cur)
            cur = b
    if t1 > cur:
        gaps.append((cur, t1))
    return busy, gaps


def base_name(name: str) -> str:
    """A kernel's unqualified name: :func:`short_name` past its last
    ``::`` (``repro_torch::segment_few_lane_kernel`` -> ``segment_few_lane_kernel``)."""
    return short_name(name).rsplit("::", 1)[-1]


def top_ops(ops: Sequence[DeviceOp], n: int = 10) -> List[List[object]]:
    tot: Dict[str, float] = defaultdict(float)
    for o in ops:
        tot[short_name(o.name)] += o.dur_s
    return [[k, v] for k, v in sorted(tot.items(), key=lambda kv: -kv[1])[:n]]


def label_gaps(gaps: Sequence[Tuple[float, float]],
               spans: Sequence[Tuple[str, float, float, int]],
               n: int = 10) -> List[List[object]]:
    """Idle seconds summed by what the host was doing: each stretch of a gap
    goes to the deepest program span (``name``, start, end, depth) open
    over it, the latest started where several are (queries that wait in a
    drain keep their earlier spans open), else to ``harness`` (the
    benchmark's own loop between queries).  One sweep over the spans' ends
    and the gaps, both sorted."""
    events = sorted([(s[2], 0, s) for s in spans] + [(s[1], 1, s) for s in spans],
                    key=lambda e: (e[0], e[1]))
    open_at: Dict[int, set] = defaultdict(set)
    gaps = sorted(gaps)
    tot: Dict[str, float] = defaultdict(float)
    g, t_prev = 0, float("-inf")

    def label() -> str:
        depths = [d for d, o in open_at.items() if o]
        if not depths:
            return "harness"
        return max(open_at[max(depths)], key=lambda s: (s[1], s[0]))[0]

    for t, opens, s in events + [(float("inf"), 0, None)]:
        # the stretch [t_prev, t) has one label; add its overlap with gaps
        if t > t_prev:
            name = label()
            while g < len(gaps) and gaps[g][1] <= t_prev:
                g += 1
            k = g
            while k < len(gaps) and gaps[k][0] < t:
                tot[name] += max(0.0, min(gaps[k][1], t) - max(gaps[k][0], t_prev))
                k += 1
            t_prev = t
        if s is not None:
            if opens:
                open_at[s[3]].add(s)
            else:
                open_at[s[3]].discard(s)
    return [[k, v] for k, v in sorted(tot.items(), key=lambda kv: -kv[1])[:n] if v > 0]


def flatten_spans(tree: Optional[dict], t_submit: float) -> List[Tuple[str, float, float, int]]:
    """A handle's span tree (``handle.trace()``) as (path, start, end,
    depth) on the host clock."""
    out: List[Tuple[str, float, float, int]] = []
    if not tree:
        return out

    def walk(sp, path, depth):
        name = sp.get("name", "?")
        p = name if not path else f"{path}/{name}"
        start = t_submit + float(sp.get("t_start_s", 0.0))
        dur = sp.get("duration_s")
        if dur is not None:
            out.append((p, start, start + float(dur), depth))
        for c in sp.get("children", ()):
            walk(c, p, depth + 1)

    walk(tree["root"], "", 0)
    return out
