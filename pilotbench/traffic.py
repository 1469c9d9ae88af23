"""The one traffic generator: it reads a mix (``pilotbench/traffic/<mix>.json``)
and turns it into queries drawn from ``--seed``.

A mix lists query entries, each a family of :mod:`pilotbench.reference`, its
substitution parameters (each a list of values; the family's parameter sets
are every combination) and its guarantee (``[error %, confidence %]``, or
null for an exact query); an entry gives ``count`` panels at one
``guarantee``, or one panel per item of ``guarantees``.  Its ``mode`` names
the module ``pilotbench/modes/<mode>.py``, found by that name, that turns
the queries into the batches a run asks and asks them of the session.

The session settings a mix fixes (``"session"``) are passed to the
program's ``SessionConfig`` as they stand.
"""

from __future__ import annotations

import dataclasses
import importlib
import itertools
import re
from typing import Dict, Iterator, List, Optional, Tuple

import numpy as np

from pilotbench import reference


@dataclasses.dataclass(frozen=True)
class Query:
    family: str
    params: Tuple[Tuple[str, object], ...]
    guarantee: Optional[Tuple[float, float]]
    sql: str

    @property
    def key(self):
        return (self.family, self.params, self.guarantee)

    @property
    def params_dict(self) -> Dict[str, object]:
        return dict(self.params)


def parameter_sets(params: Dict[str, list]) -> List[Dict[str, object]]:
    """Every combination of the parameter lists, keys in sorted order."""
    names = sorted(params)
    return [dict(zip(names, combo))
            for combo in itertools.product(*(params[n] for n in names))]


def _guarantees(entry) -> List[Optional[Tuple[float, float]]]:
    if "guarantees" in entry:
        gs = entry["guarantees"]
    else:
        gs = [entry.get("guarantee")] * int(entry.get("count", 1))
    return [None if g is None else (float(g[0]), float(g[1])) for g in gs]


def make_query(family: str, params: Dict[str, object], guarantee) -> Query:
    fam = reference.family(family)
    return Query(family, tuple(sorted(params.items())), guarantee,
                 reference.render(fam, params, guarantee))


def _rng(seed: int, stream: int) -> np.random.Generator:
    return np.random.default_rng(np.random.SeedSequence([int(seed) % (1 << 64), stream]))


_NAME = re.compile(r"^[a-z][a-z0-9_]*$")


def cycle(items: list, rng: np.random.Generator) -> Iterator:
    while True:
        for i in rng.permutation(len(items)):
            yield items[i]


def mode(name: str):
    """The mode module ``pilotbench.modes.<name>``."""
    if not _NAME.match(name):
        raise ValueError(f"bad mode name {name!r}")
    return importlib.import_module(f"pilotbench.modes.{name}")


class Traffic:
    """The queries of one mix under one seed."""

    def __init__(self, mix: dict, seed: int):
        self.mix = mix
        self.mode = mode(mix["mode"])
        self.seed = int(seed)
        self.entries = [(e["family"], parameter_sets(e.get("params", {})),
                         _guarantees(e)) for e in mix["queries"]]

    def rng(self, stream: int) -> np.random.Generator:
        return _rng(self.seed, stream)

    def distinct(self) -> List[Query]:
        """Every query the mix can ask, once, in file order."""
        out, seen = [], set()
        for family, sets, gs in self.entries:
            for g in gs:
                for p in sets:
                    q = make_query(family, p, g)
                    if q.key not in seen:
                        seen.add(q.key)
                        out.append(q)
        return out

    def batches(self) -> Iterator[List[Query]]:
        """The window's batches, each asked at once (:mod:`pilotbench.modes`)."""
        return self.mode.batches(self)

    def warm(self) -> List[List[Query]]:
        """The batches set-up asks before the window."""
        return self.mode.warm(self)
