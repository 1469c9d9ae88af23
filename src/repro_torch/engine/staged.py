"""Materialized block-sample catalog: pre-staged sample ladders.

Every fresh execution draws its block sample with host RNG over ALL block
ids and the kernels read the sampled slabs out of the full table.  For hot
tables serving constant-varied dashboard herds — workloads the result cache
cannot answer — that per-query O(N) draw is overhead: VerdictDB's
"scrambles" and BlinkDB's stratified samples pre-materialize the sample once
and serve every query from it.

This module is that idea made bit-identical.  A :class:`StagedLadder` pins
ONE content-derived staging seed per table and materializes the Bernoulli
block draw at a ladder of rates (default 1% / 4% / 16%) as
:class:`~repro_torch.engine.table.BlockTable` rungs on the table's device
(per shard for a ``ShardedTable``).  At execution the smallest rung whose
rate covers the required rate serves a *sub-draw* of the staged
realization: under the one-uniform-vector draw (``rng.random(N) < rate``) a
draw at rate r <= R with the same seed is a restriction of the rung's draw
(``sampling.subdraw_positions``), so the sub-drawn blocks are rows the rung
already holds, addressed by their *positions* within it.  The query runs on
the rung's tensors through the physical layer's ordinary routes — the
column kernels and the gather route alike — with the physical block count
forced to the value the fresh path would use (bucketed against the ORIGIN
block count).  Each kernel's per-block output depends only on the block's
rows, padding rows are masked by ``n_real`` and never by what they read,
and the forced ``n_phys`` keeps every launch plan (blocks per warp,
``segment_sum``'s route) the fresh draw's: answers are bitwise those of a
fresh draw, for pilots and finals, monolithic and distributed.

Lifecycle.  ``register_table`` invalidates the table's ladder and refreshes
every OTHER ladder's replicated catalog entries in place.  An optional byte
budget bounds rung residency, LRU-evicting whole ladders' tensors; the
ladder *record* — its pinned seed — survives eviction, so a post-eviction
fresh draw replays the same realization and answers stay bitwise equal
across the hit/miss boundary.
"""

from __future__ import annotations

import dataclasses
import threading
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch.engine.physical import PhysicalCompiler
from repro_torch.engine.sampling import (bucket_blocks, draw_block_ids,
                                         restrict_block_ids, subdraw_positions)
from repro_torch.engine.table import BlockTable
from repro_torch.obs import trace as _trace

DEFAULT_STAGED_RATES: Tuple[float, ...] = (0.01, 0.04, 0.16)

# Tolerance for "rung covers rate": TAQA-chosen rates are floats computed
# from pilot statistics; a rung must not be rejected on representation noise.
_RATE_EPS = 1e-12


def validate_rates(rates: Sequence[float]) -> Tuple[float, ...]:
    """Normalize a ladder's rate list: non-empty, each in (0, 1], ascending."""
    rates = tuple(float(r) for r in rates)
    if not rates:
        raise ValueError("staged_rates must be non-empty")
    for r in rates:
        if not (0.0 < r <= 1.0):
            raise ValueError(f"staged rate must be in (0, 1], got {r}")
    return tuple(sorted(rates))


@dataclasses.dataclass
class ShardRungPart:
    """One shard's slice of a rung (dist route): the shard-local rung ids,
    the gathered shard-rung table, and a compiler whose catalog maps the
    staged table to it (other tables replicated, as dist execution does)."""

    shard_index: int
    start_block: int             # global offset of this shard's block range
    shard_blocks: int            # the shard's TOTAL block count (fresh n_phys cap)
    local_ids: np.ndarray        # rung block ids local to the shard, ascending
    table: Optional[BlockTable]  # None when the rung misses this shard
    compiler: Optional[PhysicalCompiler]


@dataclasses.dataclass
class StagedRung:
    """One materialized rate of a ladder.

    ``ids`` are the GLOBAL block ids of the staged draw (ascending).  The
    monolithic route uses ``table`` / ``compiler``; the dist route uses
    ``parts``.  ``resident`` flips to False when the byte budget evicts the
    tensors — the rung then behaves as absent and queries fall back to fresh
    draws under the ladder's pinned seed.
    """

    rate: float
    ids: np.ndarray
    table: Optional[BlockTable] = None
    compiler: Optional[PhysicalCompiler] = None
    parts: Optional[List[ShardRungPart]] = None
    nbytes: int = 0
    resident: bool = True

    def drop_arrays(self) -> None:
        self.table = None
        self.compiler = None
        self.parts = None
        self.nbytes = 0
        self.resident = False


class StagedLadder:
    """A table's staged sample ladder: pinned seed, rungs, sub-draw memo.

    ``sharded`` pins the exact :class:`repro_torch.dist.ShardedTable` the
    per-shard rungs were gathered from; the dist route only serves from the
    ladder while its snapshot IS that object.
    """

    def __init__(self, name: str, rates: Sequence[float], seed: int,
                 num_blocks: int, rungs: List[StagedRung], sharded=None):
        self.name = name
        self.rates = tuple(rates)
        self.seed = int(seed)
        self.num_blocks = int(num_blocks)
        self.rungs = rungs
        self.sharded = sharded
        self.last_used = 0
        self._lock = threading.Lock()
        # (route, rung rate, query rate) -> prepared sub-draw.  The seed is
        # pinned and the rung realization fixed, so the sub-draw is a pure
        # function of the rate: memoizing it takes the per-query O(N) host
        # draw and the ids' host-to-device copy off the warm path.
        self._memo: Dict[tuple, object] = {}

    def rung_for(self, rate: float) -> Optional[StagedRung]:
        """Smallest resident rung covering ``rate``, or None (fresh path)."""
        for rung in self.rungs:
            if rung.resident and rung.rate >= rate - _RATE_EPS:
                return rung
        return None

    def memo(self, key: tuple, build):
        """The memoized ``build()``; ``build`` returns None for a rung the
        budget dropped, and that None is not memoized."""
        with self._lock:
            if key not in self._memo:
                value = build()
                if value is None:
                    return None
                self._memo[key] = value
            return self._memo[key]

    @property
    def resident_bytes(self) -> int:
        return sum(r.nbytes for r in self.rungs if r.resident)

    def drop_rungs(self) -> None:
        # under the memo's lock: a sub-draw is built either before the drop,
        # and then holds the rung's tensors and compiler itself, or after it,
        # and then sees the rung gone and is no hit
        with self._lock:
            for r in self.rungs:
                r.drop_arrays()
            self._memo.clear()


class SampleCatalog:
    """Thread-safe registry of staged ladders with an optional byte budget.

    The budget governs rung residency, not ladder existence: eviction drops
    a cold ladder's tensors (LRU whole-ladder) but keeps the record and its
    pinned staging seed, so later queries miss to fresh draws of the SAME
    realization — bit-identity survives eviction.
    """

    def __init__(self, max_bytes: Optional[int] = None):
        if max_bytes is not None and max_bytes < 0:
            raise ValueError(f"max_bytes must be >= 0, got {max_bytes}")
        self.max_bytes = max_bytes
        self._lock = threading.Lock()
        self._ladders: Dict[str, StagedLadder] = {}
        self._use_counter = 0
        self.hits = 0        # staged sub-draws served
        self.misses = 0      # fresh draws of ladder-bearing tables
        self.evictions = 0   # ladders whose rung tensors the budget dropped

    # -- registration ---------------------------------------------------------
    def admit(self, ladder: StagedLadder) -> None:
        with self._lock:
            self._use_counter += 1
            ladder.last_used = self._use_counter
            self._ladders[ladder.name] = ladder
            self._enforce_budget()

    def invalidate(self, name: str) -> None:
        with self._lock:
            self._ladders.pop(name, None)

    def refresh_replicated(self, name: str, table: BlockTable) -> None:
        """A table was re-registered: point every OTHER ladder's rung
        compilers at the new tensors (rung catalogs replicate non-staged
        tables exactly as dist shard executors do)."""
        with self._lock:
            ladders = [lad for t, lad in self._ladders.items() if t != name]
        copies = {}
        for lad in ladders:
            for rung in lad.rungs:
                compilers = ([rung.compiler] if rung.compiler else []) + \
                    [p.compiler for p in rung.parts or [] if p.compiler]
                for c in compilers:
                    if name in c.catalog:
                        dev = c.catalog[lad.name].device
                        if dev not in copies:
                            copies[dev] = table.to(dev)
                        c.catalog[name] = copies[dev]

    # -- lookup ---------------------------------------------------------------
    def ladder(self, name: str) -> Optional[StagedLadder]:
        with self._lock:
            lad = self._ladders.get(name)
            if lad is not None:
                self._use_counter += 1
                lad.last_used = self._use_counter
            return lad

    def seed_for(self, name: str, default: int) -> int:
        """The pinned staging seed when ``name`` has a ladder, else
        ``default`` — ladder-bearing tables draw every block sample from
        their staging seed, so hits and misses share one realization."""
        with self._lock:
            lad = self._ladders.get(name)
        return lad.seed if lad is not None else default

    # -- counters (the one staged hit / miss choke point, mono and dist) -------
    # the trace tags ride along with the counters (no-ops untraced)
    def note_hit(self) -> None:
        with self._lock:
            self.hits += 1
        _trace.annotate_count("staged_hits")

    def note_miss(self) -> None:
        with self._lock:
            self.misses += 1
        _trace.annotate_count("staged_misses")

    # -- budget ---------------------------------------------------------------
    def _enforce_budget(self) -> None:  # caller holds the lock
        if self.max_bytes is None:
            return
        while (sum(l.resident_bytes for l in self._ladders.values())
               > self.max_bytes):
            victims = [l for l in self._ladders.values()
                       if l.resident_bytes > 0]
            if not victims:
                break
            min(victims, key=lambda l: l.last_used).drop_rungs()
            self.evictions += 1

    @property
    def resident_bytes(self) -> int:
        with self._lock:
            return sum(l.resident_bytes for l in self._ladders.values())

    # -- reporting ------------------------------------------------------------
    def compile_totals(self) -> Tuple[int, int, int]:
        """(hits, misses, size) summed over every rung compiler's cache."""
        with self._lock:
            ladders = list(self._ladders.values())
        hits = misses = size = 0
        for lad in ladders:
            for rung in lad.rungs:
                compilers = ([rung.compiler] if rung.compiler else []) + \
                    [p.compiler for p in rung.parts or [] if p.compiler]
                for c in compilers:
                    info = c.cache_info()
                    hits += info.hits
                    misses += info.misses
                    size += info.size
        return hits, misses, size

    def info(self) -> Dict[str, object]:
        with self._lock:
            tables = {
                name: {
                    "rates": list(lad.rates),
                    "resident_rates": [r.rate for r in lad.rungs if r.resident],
                    "resident_bytes": lad.resident_bytes,
                    "sharded": lad.sharded is not None,
                }
                for name, lad in self._ladders.items()
            }
            return {
                "hits": self.hits,
                "misses": self.misses,
                "evictions": self.evictions,
                "resident_bytes": sum(l.resident_bytes
                                      for l in self._ladders.values()),
                "max_bytes": self.max_bytes,
                "tables": tables,
            }


# -- ladder construction ------------------------------------------------------
def build_ladder(name: str, table: BlockTable, rates: Sequence[float],
                 seed: int, base_catalog: Dict[str, BlockTable]) -> StagedLadder:
    """Materialize a monolithic ladder: one gather per rung on the table's
    device, one compiler per rung whose catalog maps ``name`` to the rung
    and replicates every other table from ``base_catalog``."""
    rungs: List[StagedRung] = []
    for rate in validate_rates(rates):
        ids = draw_block_ids(table.num_blocks, rate, seed)
        if len(ids):
            rung_table = table.gather_blocks(ids)
            cat = dict(base_catalog)
            cat[name] = rung_table
            rungs.append(StagedRung(
                rate=rate, ids=ids, table=rung_table,
                compiler=PhysicalCompiler(cat),
                nbytes=rung_table.total_bytes()))
        else:
            # An empty rung still SERVES: any sub-draw of it is empty, and a
            # fresh draw at a covered rate under the same seed would be
            # empty too (restriction).
            rungs.append(StagedRung(rate=rate, ids=ids))
    return StagedLadder(name, [r.rate for r in rungs], seed,
                        table.num_blocks, rungs)


def build_sharded_ladder(name: str, sharded, rates: Sequence[float],
                         seed: int, shard_catalogs: List[Dict[str, BlockTable]]
                         ) -> StagedLadder:
    """Materialize a per-shard ladder for a :class:`repro_torch.dist.ShardedTable`.

    The rung draw is the GLOBAL realization (the monolithic ladder's); each
    shard gathers its restriction of it on the shard's device, so the union
    of the shard rungs is the monolithic rung block for block.
    """
    rungs: List[StagedRung] = []
    for rate in validate_rates(rates):
        global_ids = draw_block_ids(sharded.num_blocks, rate, seed)
        parts: List[ShardRungPart] = []
        nbytes = 0
        for shard, cat in zip(sharded.shards, shard_catalogs):
            local = restrict_block_ids(global_ids, shard.start_block,
                                       shard.end_block)
            if len(local):
                part_table = shard.table.gather_blocks(local)
                part_cat = dict(cat)
                part_cat[name] = part_table
                compiler = PhysicalCompiler(part_cat)
                nbytes += part_table.total_bytes()
            else:
                part_table, compiler = None, None
            parts.append(ShardRungPart(
                shard_index=shard.index, start_block=shard.start_block,
                shard_blocks=shard.num_blocks, local_ids=local,
                table=part_table, compiler=compiler))
        rungs.append(StagedRung(rate=rate, ids=global_ids, parts=parts,
                                nbytes=nbytes))
    return StagedLadder(name, [r.rate for r in rungs], seed,
                        sharded.num_blocks, rungs, sharded=sharded)


# -- sub-draw preparation -----------------------------------------------------
def _padded_on(table: Optional[BlockTable], positions: np.ndarray,
               n_real: int, n_phys: int):
    """``positions`` zero-padded to ``n_phys``, and its device copies on
    ``table``'s device: the ids and ``n_real`` as int32 tensors.  The
    positions are range checked here, once, against the rung's block count
    (the kernels and the gather index the rung with them)."""
    pad = n_phys - n_real
    phys = np.concatenate([positions, np.zeros(pad, np.int32)]) \
        if pad > 0 else positions
    phys = np.ascontiguousarray(phys, dtype=np.int32)
    if table is None:  # an empty rung serves only empty sub-draws
        return phys, None, None
    if len(phys) and (phys.min() < 0 or phys.max() >= table.num_blocks):
        raise ValueError(f"rung positions must lie in [0, {table.num_blocks})")
    return (phys, torch.from_numpy(phys).to(table.device),
            torch.tensor(n_real, dtype=torch.int32, device=table.device))


@dataclasses.dataclass(frozen=True)
class MonoSubdraw:
    """A memoized monolithic sub-draw, ready for dispatch: the global block
    ids the query samples, and their rung positions padded to the PHYSICAL
    block count the fresh path would use (bucketed against the ORIGIN block
    count, so it may exceed the rung's own) — the fresh ``n_phys`` keeps
    shapes, launch plans, padding masks and reduction order the fresh
    draw's.

    ``phys_dev`` / ``nreal_dev`` are the device copies, made ONCE at memo
    build: warm dispatches skip the host range check and the host-to-device
    copy the fresh path pays on every query.  ``compiler`` is the rung's,
    taken at memo build: a sub-draw keeps its rung's tensors alive through
    an eviction that comes after the lookup."""

    sub_ids: np.ndarray      # global block ids, ascending
    phys: np.ndarray         # rung-local positions, zero-padded to n_phys
    n_real: int
    n_phys: int
    compiler: Optional[PhysicalCompiler] = None  # None only for an empty rung
    phys_dev: Optional[torch.Tensor] = None   # (n_phys,) int32 on the rung's device
    nreal_dev: Optional[torch.Tensor] = None  # int32 scalar on the rung's device


def prepare_mono_subdraw(ladder: StagedLadder, rung: StagedRung,
                         rate: float) -> Optional[MonoSubdraw]:
    """The memoized sub-draw of ``rung`` at ``rate``, or None when the
    budget dropped the rung after ``rung_for`` returned it (a miss: the
    caller draws fresh under the pinned seed)."""
    def build() -> Optional[MonoSubdraw]:
        if not rung.resident:
            return None
        sub_ids, positions = subdraw_positions(
            rung.ids, ladder.num_blocks, rate, ladder.seed)
        n_real = int(len(sub_ids))
        n_phys = min(bucket_blocks(max(n_real, 1)), ladder.num_blocks)
        phys, phys_dev, nreal_dev = _padded_on(rung.table, positions,
                                               n_real, n_phys)
        return MonoSubdraw(sub_ids, phys, n_real, n_phys, rung.compiler,
                           phys_dev=phys_dev, nreal_dev=nreal_dev)
    return ladder.memo(("mono", rung.rate, float(rate)), build)


@dataclasses.dataclass(frozen=True)
class ShardSubdraw:
    """One shard's slice of a dist sub-draw (only shards with >= 1 sampled
    block appear, as in ``ShardedTable.partition_ids``).  Like
    :class:`MonoSubdraw`, the padded positions are staged on the device
    once at memo build (``n_phys`` forced to the fresh per-shard value)."""

    part: ShardRungPart
    local_ids: np.ndarray    # sub-drawn block ids local to the shard
    positions: np.ndarray    # their positions within the shard's rung
    n_real: int = 0
    n_phys: int = 0
    phys: Optional[np.ndarray] = None   # positions zero-padded to n_phys
    phys_dev: Optional[torch.Tensor] = None
    nreal_dev: Optional[torch.Tensor] = None


def prepare_dist_subdraw(ladder: StagedLadder, rung: StagedRung, rate: float
                         ) -> Optional[Tuple[np.ndarray, List[ShardSubdraw]]]:
    """(global sub-drawn ids, per-shard splits) for the dist staged route,
    or None when the budget dropped the rung after ``rung_for`` returned it.
    Each split holds its shard part, and so the part's tensors and
    compiler."""
    def build():
        if not rung.resident:
            return None
        global_ids = draw_block_ids(ladder.num_blocks, rate, ladder.seed)
        splits: List[ShardSubdraw] = []
        for part in rung.parts:
            local = restrict_block_ids(
                global_ids, part.start_block,
                part.start_block + part.shard_blocks)
            if len(local) == 0:
                continue
            positions = np.searchsorted(part.local_ids, local).astype(np.int32)
            n_real = int(len(local))
            n_phys = min(bucket_blocks(max(n_real, 1)), part.shard_blocks)
            phys, phys_dev, nreal_dev = _padded_on(part.table, positions,
                                                   n_real, n_phys)
            splits.append(ShardSubdraw(
                part, local, positions, n_real=n_real, n_phys=n_phys,
                phys=phys, phys_dev=phys_dev, nreal_dev=nreal_dev))
        return global_ids, splits
    return ladder.memo(("dist", rung.rate, float(rate)), build)
