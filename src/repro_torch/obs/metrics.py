"""Unified metrics registry: counters, gauges, histograms, collectors.

One :class:`MetricsRegistry` per :class:`Session` absorbs the counters that
used to be scattered across the engine (compile cache hits/misses, result
cache, staged residency, pilot fan-out, frame push/drop, backpressure
rejections): components either own first-class instruments (counter /
gauge / histogram) or register a *collector* — a zero-arg callable returning
a nested dict snapshot of state the component already tracks (cache info
structs, shard scan tallies).  :meth:`MetricsRegistry.tree` is the nested
snapshot a serving front reports, and :meth:`MetricsRegistry.to_text`
renders everything — instruments and collector snapshots alike — in
Prometheus text exposition format.

Collectors hold only weak references to their owners, so registering a
session's caches with the process-wide ``GLOBAL`` registry never extends
their lifetime; dead collectors are pruned at read time.
"""

from __future__ import annotations

import bisect
import re
import threading
import weakref
from typing import Callable, Dict, List, Optional, Tuple

__all__ = [
    "Counter", "Gauge", "Histogram", "MetricsRegistry", "GLOBAL",
    "register_session_collectors",
]

_NAME_RE = re.compile(r"[^a-zA-Z0-9_]")


def _sanitize(name: str) -> str:
    name = _NAME_RE.sub("_", name)
    if name and name[0].isdigit():
        name = "_" + name
    return name


def _escape_help(s: str) -> str:
    """Prometheus text exposition: HELP text must escape backslash and
    line feed (an unescaped newline would split the comment into a bogus
    sample line and break the scrape)."""
    return s.replace("\\", "\\\\").replace("\n", "\\n")


class Counter:
    """Monotonic counter (thread-safe)."""

    kind = "counter"

    def __init__(self, name: str, help: str = ""):
        self.name = name
        self.help = help
        self._lock = threading.Lock()
        self._value = 0.0

    def inc(self, n: float = 1.0) -> None:
        with self._lock:
            self._value += n

    @property
    def value(self) -> float:
        with self._lock:
            return self._value


class Gauge:
    """Point-in-time value (thread-safe)."""

    kind = "gauge"

    def __init__(self, name: str, help: str = ""):
        self.name = name
        self.help = help
        self._lock = threading.Lock()
        self._value = 0.0

    def set(self, v: float) -> None:
        with self._lock:
            self._value = float(v)

    def inc(self, n: float = 1.0) -> None:
        with self._lock:
            self._value += n

    @property
    def value(self) -> float:
        with self._lock:
            return self._value


# Default buckets suit sub-second query-stage latencies (seconds).
_DEFAULT_BUCKETS = (0.001, 0.005, 0.01, 0.05, 0.1, 0.5, 1.0, 5.0, 10.0)


class Histogram:
    """Cumulative-bucket histogram, Prometheus style (thread-safe)."""

    kind = "histogram"

    def __init__(self, name: str, help: str = "",
                 buckets: Tuple[float, ...] = _DEFAULT_BUCKETS):
        self.name = name
        self.help = help
        self.buckets = tuple(sorted(buckets))
        self._lock = threading.Lock()
        self._counts = [0] * (len(self.buckets) + 1)  # +inf tail
        self._sum = 0.0
        self._count = 0
        self._max = 0.0

    def observe(self, v: float) -> None:
        v = float(v)
        with self._lock:
            self._counts[bisect.bisect_left(self.buckets, v)] += 1
            self._sum += v
            self._count += 1
            if v > self._max:
                self._max = v

    @property
    def count(self) -> int:
        with self._lock:
            return self._count

    @property
    def sum(self) -> float:
        with self._lock:
            return self._sum

    @property
    def max(self) -> float:
        with self._lock:
            return self._max

    def snapshot(self) -> Dict[str, object]:
        with self._lock:
            cum, out = 0, []
            for le, n in zip(self.buckets, self._counts):
                cum += n
                out.append((le, cum))
            return {
                "count": self._count,
                "sum": self._sum,
                "max": self._max,
                "buckets": out,
            }


class MetricsRegistry:
    """Named instruments plus weakly-owned collector snapshots."""

    def __init__(self) -> None:
        self._lock = threading.Lock()
        self._instruments: Dict[str, object] = {}
        # name -> (fn, owner_ref | None); owner death prunes the collector
        self._collectors: Dict[
            str, Tuple[Callable[[], Dict], Optional[weakref.ref]]] = {}

    # -- instruments (get-or-create; kind mismatch is a bug) ------------------
    def counter(self, name: str, help: str = "") -> Counter:
        return self._get(name, help, Counter)

    def gauge(self, name: str, help: str = "") -> Gauge:
        return self._get(name, help, Gauge)

    def histogram(self, name: str, help: str = "",
                  buckets: Tuple[float, ...] = _DEFAULT_BUCKETS) -> Histogram:
        with self._lock:
            inst = self._instruments.get(name)
            if inst is None:
                inst = Histogram(name, help, buckets)
                self._instruments[name] = inst
            elif not isinstance(inst, Histogram):
                raise TypeError(
                    f"metric {name!r} already registered as {inst.kind}")
            return inst

    def _get(self, name, help, cls):
        with self._lock:
            inst = self._instruments.get(name)
            if inst is None:
                inst = cls(name, help)
                self._instruments[name] = inst
            elif not isinstance(inst, cls):
                raise TypeError(
                    f"metric {name!r} already registered as {inst.kind}")
            return inst

    # -- collectors -----------------------------------------------------------
    def register_collector(self, name: str, fn: Callable[[], Dict],
                           owner: Optional[object] = None) -> None:
        """Register (or replace) a named snapshot source.  When ``owner`` is
        given only a weak reference is kept; the collector disappears with
        its owner."""
        ref = weakref.ref(owner) if owner is not None else None
        with self._lock:
            self._collectors[name] = (fn, ref)

    def _live_collectors(self) -> List[Tuple[str, Callable[[], Dict]]]:
        with self._lock:
            dead = [n for n, (_, r) in self._collectors.items()
                    if r is not None and r() is None]
            for n in dead:
                del self._collectors[n]
            return [(n, fn) for n, (fn, _) in self._collectors.items()]

    def tree(self) -> Dict[str, Dict]:
        """{collector_name: snapshot_dict} for every live collector."""
        return {name: fn() for name, fn in self._live_collectors()}

    def instruments(self) -> Dict[str, object]:
        with self._lock:
            return dict(self._instruments)

    # -- Prometheus text exposition ------------------------------------------
    def to_text(self) -> str:
        lines: List[str] = []
        # every metric name already emitted: instruments' own names, the
        # histogram child series they synthesize, and flattened collector
        # gauges — a second emission of any of them (e.g. a collector whose
        # flattened path collides with an instrument) would be an invalid
        # exposition (duplicate # TYPE), so later duplicates are skipped
        seen: set = set()
        for name in sorted(self.instruments()):
            inst = self._instruments[name]
            mname = _sanitize(name)
            if mname in seen:
                continue  # two raw names sanitizing to one metric name
            seen.add(mname)
            if inst.help:
                lines.append(f"# HELP {mname} {_escape_help(inst.help)}")
            lines.append(f"# TYPE {mname} {inst.kind}")
            if isinstance(inst, Histogram):
                seen.update((f"{mname}_bucket", f"{mname}_sum",
                             f"{mname}_count"))
                snap = inst.snapshot()
                for le, cum in snap["buckets"]:
                    lines.append(f'{mname}_bucket{{le="{le:g}"}} {cum}')
                lines.append(
                    f'{mname}_bucket{{le="+Inf"}} {snap["count"]}')
                lines.append(f"{mname}_sum {snap['sum']:.9g}")
                lines.append(f"{mname}_count {snap['count']}")
            else:
                lines.append(f"{mname} {inst.value:.9g}")
        # Collector snapshots flatten to gauges by path-joined name.
        for cname, fn in sorted(self._live_collectors()):
            try:
                snap = fn()
            except Exception:  # a dying component must not break scrape
                continue
            for path, value in sorted(_flatten(cname, snap)):
                if path in seen:
                    continue
                seen.add(path)
                lines.append(f"# TYPE {path} gauge")
                lines.append(f"{path} {value:.9g}")
        return "\n".join(lines) + "\n"


def _flatten(prefix: str, obj) -> List[Tuple[str, float]]:
    out: List[Tuple[str, float]] = []
    p = _sanitize(prefix)
    if isinstance(obj, dict):
        for k, v in obj.items():
            out.extend(_flatten(f"{p}_{k}", v))
    elif isinstance(obj, (list, tuple)):
        for i, v in enumerate(obj):
            out.extend(_flatten(f"{p}_{i}", v))
    elif isinstance(obj, bool):
        out.append((p, 1.0 if obj else 0.0))
    elif isinstance(obj, (int, float)):
        out.append((p, float(obj)))
    # strings / None are dropped from exposition (kept in tree())
    return out


#: Process-wide registry.  Sessions attach their own registries' collectors
#: here (weakly) so one scrape sees every live session.
GLOBAL = MetricsRegistry()


def register_session_collectors(registry: MetricsRegistry, session) -> None:
    """Wire a session's existing stat sources into ``registry`` as
    collectors.  Duck-typed via getattr so this module never imports
    ``repro_torch.api`` (no circularity); every collector holds the session
    weakly and degrades to zeros/skeletons when a source is absent."""
    ref = weakref.ref(session)

    def compile_cache() -> Dict:
        s = ref()
        if s is None:
            return {}
        info = s.compile_cache_info()  # the port's engine CacheInfo
        return {
            "hits": info.hits,
            "misses": info.misses,
            "size": info.size,
            "staged_hits": info.staged_hits,
            "staged_misses": info.staged_misses,
            # per-path attribution of the totals above (hits/misses stay the
            # grand totals): pilot lowerings, drain-group batch callables and
            # fused single-launch programs
            "pilot_hits": info.pilot_hits,
            "pilot_misses": info.pilot_misses,
            "batched_hits": info.batched_hits,
            "batched_misses": info.batched_misses,
            "fused_hits": info.fused_hits,
            "fused_misses": info.fused_misses,
            # local misses whose build a same-geometry dist shard made
            "shared_hits": info.shared_hits,
        }

    def result_cache() -> Dict:
        s = ref()
        if s is None:
            return {}
        info = s.result_cache.info()
        return {
            "hits": info.hits,
            "misses": info.misses,
            "evictions": info.evictions,
            "invalidations": info.invalidations,
            "size": info.size,
            "capacity": info.capacity,
            "bytes_used": info.bytes_used,
            "max_bytes": info.max_bytes,
            "hit_rate": info.hit_rate,
        }

    def staged() -> Dict:
        s = ref()
        out = {"hits": 0, "misses": 0, "evictions": 0,
               "resident_bytes": 0, "max_bytes": None, "tables": {}}
        if s is None:
            return out
        info_fn = getattr(s.executor, "staged_info", None)
        if info_fn is not None:
            out.update(info_fn())
        return out

    def shard_scanned_bytes() -> Dict:
        s = ref()
        if s is None:
            return {}
        info_fn = getattr(s.executor, "shard_scan_info", None)
        if info_fn is None:
            return {}
        return {t: list(v) for t, v in info_fn().items()}

    def runtime() -> Dict:
        s = ref()
        if s is None:
            return {}
        out = {
            "queries_run": getattr(s.executor, "queries_run", 0),
            "pilots_run": getattr(s.executor, "pilots_run", 0),
        }
        rt = getattr(s, "runtime", None)
        if rt is not None:
            out.update(rt.totals())
        return out

    def audit() -> Dict:
        s = ref()
        auditor = getattr(s, "auditor", None) if s is not None else None
        if auditor is None:
            return {"runs": 0, "violations": 0, "errors": 0,
                    "max_error_ratio": 0.0}
        return auditor.summary()

    def timeseries() -> Dict:
        s = ref()
        ts = getattr(s, "timeseries", None) if s is not None else None
        if ts is None:  # telemetry off: full-key skeleton, zero state
            from repro_torch.obs.timeseries import empty_snapshot
            return empty_snapshot()
        return ts.snapshot()

    def slo() -> Dict:
        s = ref()
        mon = getattr(s, "slo", None) if s is not None else None
        if mon is None:
            from repro_torch.obs.slo import empty_summary
            return empty_summary()
        return mon.summary()

    registry.register_collector("compile_cache", compile_cache, owner=session)
    registry.register_collector("result_cache", result_cache, owner=session)
    registry.register_collector("staged", staged, owner=session)
    registry.register_collector(
        "shard_scanned_bytes", shard_scanned_bytes, owner=session)
    registry.register_collector("runtime", runtime, owner=session)
    registry.register_collector("audit", audit, owner=session)
    registry.register_collector("timeseries", timeseries, owner=session)
    registry.register_collector("slo", slo, owner=session)
