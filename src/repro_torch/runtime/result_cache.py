"""Session-level LRU cache of finished approximate answers (pure Python,
copied from the reference).

The many-users workload re-issues *identical* dashboards: same plan
structure, same predicate constants, same ErrorSpec.  Because the session
derives sampling seeds from query *content* (see
``repro_torch.api.Session._derive_seed``), an identical re-issue maps to an
identical ``(query, spec, seed)`` triple — so its answer (values AND the
a-priori error report, which stays valid while the data is unchanged) can be
returned straight from this cache without touching the executor.  This is
the BlinkDB stance at the serving layer: a bounded-error answer is reusable
state, not a one-shot.

Keying.  The key is ``(query, spec, seed)`` where ``query`` is the frozen
:class:`repro_torch.core.taqa.Query` dataclass.  That embeds the structural
signature *and* the predicate constants *and* the user-facing aggregate
names, while ``spec``/``seed`` pin the guarantee target and the sampling
realization — i.e. the (structural signature, predicate constants,
ErrorSpec, seed) key, carried by the dataclasses that already exist.

Entries.  Sessions store :class:`CachedAnswer` records, not full
``ApproxAnswer`` object graphs: the per-group values, the error report, and
the group-present bitmap *packed* (``np.packbits``, 8 groups per byte).  At
many-dashboard scale that is what lets the cache hold thousands of grouped
answers; ``max_bytes`` adds an explicit byte budget on top of the entry
count, evicting LRU-first once either bound is hit.

Invalidation.  ``invalidate_table(name)`` evicts every entry whose plan
scans ``name``; :meth:`repro_torch.api.Session.register_table` calls it, so a
table replacement can never serve answers computed against the old data.
All operations are lock-guarded — runtime workers consult the cache
concurrently.
"""

from __future__ import annotations

import dataclasses
import sys
import threading
from collections import OrderedDict
from typing import Hashable, List, Optional, Tuple

import numpy as np

# Fixed per-entry overhead estimate (key tuple, report object, OrderedDict
# slot) charged against the byte budget so "many tiny entries" cannot blow
# past it on container overhead alone.
_ENTRY_OVERHEAD_BYTES = 512


@dataclasses.dataclass
class CachedAnswer:
    """A finished answer in cache-resident form.

    ``group_present`` is bit-packed; ``to_answer()`` rebuilds a fresh
    :class:`repro_torch.core.taqa.ApproxAnswer` on every hit (values/report are
    shared read-only, the bitmap is unpacked per hit).

    ``pilot`` records the query's compact advisory
    :class:`repro_torch.core.taqa.PilotEstimate` (point estimates + CI
    half-widths as host numpy, never the per-block matrix) when its pilot
    produced one, so a *streaming* cached re-issue replays a provisional
    frame before its terminal one; :meth:`nbytes` charges it to the byte
    budget like everything else.
    """

    names: List[str]
    values: np.ndarray           # (num_composites, max_groups) float64
    present_bits: np.ndarray     # packbits(group_present) uint8
    n_groups: int
    report: object               # the TaqaReport guaranteed at compute time
    pilot: Optional[object] = None  # PilotEstimate (duck-typed: .nbytes())

    @classmethod
    def from_answer(cls, answer, pilot=None) -> "CachedAnswer":
        present = np.asarray(answer.group_present, dtype=bool)
        return cls(names=list(answer.names),
                   values=np.asarray(answer.values),
                   present_bits=np.packbits(present),
                   n_groups=present.shape[0],
                   report=answer.report,
                   pilot=pilot)

    def to_answer(self):
        from repro_torch.core.taqa import ApproxAnswer  # session-layer dependency
        present = np.unpackbits(self.present_bits,
                                count=self.n_groups).astype(bool)
        return ApproxAnswer(names=list(self.names), values=self.values,
                            group_present=present, report=self.report)

    def nbytes(self) -> int:
        pilot_bytes = 0 if self.pilot is None else self.pilot.nbytes()
        return (self.values.nbytes + self.present_bits.nbytes
                + sum(len(n) for n in self.names) + pilot_bytes
                + _ENTRY_OVERHEAD_BYTES)


def _entry_bytes(value) -> int:
    """Byte charge of a cached value: CachedAnswer knows its size; foreign
    objects are charged their shallow footprint."""
    if isinstance(value, CachedAnswer):
        return value.nbytes()
    nbytes = getattr(value, "nbytes", None)
    if isinstance(nbytes, (int, np.integer)):
        return int(nbytes) + _ENTRY_OVERHEAD_BYTES
    return sys.getsizeof(value) + _ENTRY_OVERHEAD_BYTES


@dataclasses.dataclass
class ResultCacheInfo:
    hits: int = 0
    misses: int = 0
    evictions: int = 0
    invalidations: int = 0
    size: int = 0
    capacity: int = 0
    bytes_used: int = 0
    max_bytes: Optional[int] = None

    @property
    def hit_rate(self) -> float:
        total = self.hits + self.misses
        return self.hits / total if total else 0.0


class ResultCache:
    """A thread-safe LRU of (key -> (answer, scanned table names)), bounded
    by entry count and optionally by total bytes."""

    def __init__(self, capacity: int = 128, max_bytes: Optional[int] = None):
        if capacity < 0:
            raise ValueError(f"capacity must be >= 0, got {capacity}")
        if max_bytes is not None and max_bytes < 0:
            raise ValueError(f"max_bytes must be >= 0, got {max_bytes}")
        self.capacity = capacity
        self.max_bytes = max_bytes
        self._lock = threading.Lock()
        # key -> (answer, scanned tables, byte charge)
        self._entries: "OrderedDict[Hashable, Tuple[object, frozenset, int]]" \
            = OrderedDict()
        self._bytes = 0
        self._hits = 0
        self._misses = 0
        self._evictions = 0
        self._invalidations = 0

    @property
    def enabled(self) -> bool:
        return self.capacity > 0 and (self.max_bytes is None or self.max_bytes > 0)

    def get(self, key: Hashable):
        """The cached answer for ``key``, refreshed to most-recently-used,
        or None (a miss)."""
        if not self.enabled:
            return None
        with self._lock:
            entry = self._entries.get(key)
            if entry is None:
                self._misses += 1
                return None
            self._entries.move_to_end(key)
            self._hits += 1
            return entry[0]

    def _evict_lru(self) -> None:
        _, (_, _, freed) = self._entries.popitem(last=False)
        self._bytes -= freed
        self._evictions += 1

    def put(self, key: Hashable, answer, tables, guard=None) -> None:
        """Insert an answer; ``tables`` are the scanned table names used for
        targeted invalidation.

        ``guard`` (optional, called under the cache lock) must return True
        for the insert to happen.  Sessions pass a table-generation check:
        an answer computed against data that ``register_table`` has since
        replaced would otherwise race past the invalidation — the guard runs
        under the same lock as ``invalidate_table``, so either the stale
        entry is skipped here or it lands first and the invalidation evicts
        it.
        """
        if not self.enabled:
            return
        cost = _entry_bytes(answer)
        if self.max_bytes is not None and cost > self.max_bytes:
            return  # larger than the whole budget: never resident
        with self._lock:
            if guard is not None and not guard():
                return
            old = self._entries.pop(key, None)
            if old is not None:
                self._bytes -= old[2]
            self._entries[key] = (answer, frozenset(tables), cost)
            self._bytes += cost
            while len(self._entries) > self.capacity:
                self._evict_lru()
            while self.max_bytes is not None and self._bytes > self.max_bytes:
                self._evict_lru()

    def invalidate_table(self, name: str) -> int:
        """Evict every entry whose plan scanned ``name``; returns the count."""
        with self._lock:
            stale = [k for k, (_, tables, _) in self._entries.items()
                     if name in tables]
            for k in stale:
                self._bytes -= self._entries[k][2]
                del self._entries[k]
            self._invalidations += len(stale)
            return len(stale)

    def clear(self) -> None:
        with self._lock:
            self._invalidations += len(self._entries)
            self._entries.clear()
            self._bytes = 0

    def info(self) -> ResultCacheInfo:
        """One consistent counter snapshot (single lock acquisition).  The
        session metrics registry's ``result_cache`` collector reads this —
        the numbers surfaced by ``gateway.stats_payload()["result_cache"]``
        and the Prometheus exposition are exactly these fields."""
        with self._lock:
            return ResultCacheInfo(
                hits=self._hits, misses=self._misses,
                evictions=self._evictions,
                invalidations=self._invalidations,
                size=len(self._entries), capacity=self.capacity,
                bytes_used=self._bytes, max_bytes=self.max_bytes)
