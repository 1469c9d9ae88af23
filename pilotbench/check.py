"""How ``correct`` is decided: every answer of the window against the plain
reference (:mod:`pilotbench.reference`), in float64.

Three numbers, each beside its limit:

* ``exact_gap`` -- over every exact answer (no ERROR clause, or TAQA's own
  fallback to exact): the largest relative gap of a value from the
  reference's exact value.  A group the one has and the other lacks reads
  inf.
* ``sample_gap`` -- over every approximate answer: the largest relative gap
  of a value from the reference's estimate over the same block sample (the
  final the program ran at the rates its plan chose, recorded as it ran:
  the drawn blocks of every table it sampled; every sum scaled by N / n
  where it sampled one table, by 1 / (product of the rates) where it
  sampled more).  An answer with no such final reads inf.
* ``miss_share`` -- the share of distinct approximate answers in which some
  value lies further from the reference's exact value than the query's
  ERROR, or a group the exact answer has is missing.  The guarantee states
  that a query misses with probability at most 1 - CONFIDENCE; the limit is
  the largest share of misses that a program missing at exactly that rate
  reaches with probability 1e-4 or more (:func:`miss_limit`), so a sound
  run fails it once in ten thousand at worst.

The limits of ``exact_gap`` and ``sample_gap`` are per cell, in
``pilotbench/limits/<workload>.json``.
"""

from __future__ import annotations

import dataclasses
import hashlib
import math
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from pilotbench import reference


@dataclasses.dataclass
class Final:
    """One table's sampled scan in a final the program ran: the table and
    its block sample as the program reported them."""

    table: str
    rate: float
    ids: object              # the sampled block ids (array or tensor)
    n_total: int
    n_sampled: int

    def id_array(self) -> np.ndarray:
        ids = self.ids
        if isinstance(ids, torch.Tensor):
            ids = ids.cpu().numpy()
        return np.asarray(ids, dtype=np.int64)


@dataclasses.dataclass
class Sample:
    """One sampled final of a result: the sampled scan of every table that
    it block-sampled, kept together."""

    finals: Tuple[Final, ...]

    def of(self, table: str) -> Optional[Final]:
        """The scan of ``table``, or None where the final did not sample it."""
        return next((f for f in self.finals if f.table == table), None)


@dataclasses.dataclass
class Answer:
    """One answer of the window, as the program delivered it."""

    query: object            # traffic.Query
    values: Optional[np.ndarray]
    present: Optional[np.ndarray]
    exact: bool              # no ERROR clause, or TAQA fell back to exact
    samples: List[Sample]    # candidates: finals at the plan's own rates
    error: Optional[str] = None


class Reference:
    """The reference's answers over the benchmark's own catalog, ``{table:
    {column: tensor}}``, cached per query and per sample; ``dtype`` float64,
    or lower for the control, whose float columns it stores in that dtype
    too."""

    def __init__(self, tables: Dict[str, Dict[str, torch.Tensor]],
                 block_rows: int, dtype=torch.float64):
        self.dtype = dtype
        self.block_rows = block_rows
        if dtype == torch.float64:
            self.tables = tables
        else:
            self.tables = {t: {n: (v.to(dtype) if v.is_floating_point() else v)
                               for n, v in cols.items()}
                           for t, cols in tables.items()}
        self._exact: Dict[tuple, np.ndarray] = {}
        self._sample: Dict[tuple, np.ndarray] = {}

    def prefetch(self, queries: Sequence) -> None:
        """Exact channel sums of every distinct (family, params), one pass
        over each family's tables."""
        todo: Dict[str, List[tuple]] = {}
        for q in queries:
            k = (q.family, q.params)
            if k not in self._exact and k not in todo.get(q.family, ()):
                todo.setdefault(q.family, []).append(k)
        for family, keys in todo.items():
            fam = reference.family(family)
            sums = reference.exact_sums(self.tables, fam, [dict(p) for _, p in keys],
                                        self.dtype)
            self._exact.update(zip(keys, sums))

    def exact(self, q) -> Tuple[np.ndarray, np.ndarray]:
        self.prefetch([q])
        return reference.compose(reference.family(q.family), self._exact[(q.family, q.params)])

    def sample(self, q, s: Sample) -> Tuple[np.ndarray, np.ndarray]:
        ids = [f.id_array() for f in s.finals]
        key = (q.family, q.params) + tuple(
            (f.table, f.n_total, hashlib.blake2b(i.tobytes(), digest_size=16).digest())
            for f, i in zip(s.finals, ids))
        fam = reference.family(q.family)
        if key not in self._sample:
            self._sample[key] = reference.sample_sums(
                self.tables, self.block_rows, fam, q.params_dict,
                {f.table: i for f, i in zip(s.finals, ids)}, self.dtype)
        return reference.sample_answer(
            fam, self._sample[key], [(f.rate, f.n_total, len(i)) for f, i in zip(s.finals, ids)])

    def pass_rows(self, q) -> int:
        """Rows of the (joined) table that pass the query's predicate."""
        self.prefetch([q])
        fam = reference.family(q.family)
        return int(round(self._exact[(q.family, q.params)][fam.CHANNELS.index("count")].sum()))


MISS_ALPHA = 1e-4


def miss_limit(n: int, rate: float, alpha: float = MISS_ALPHA) -> float:
    """The largest share k / n of misses with P(Binomial(n, rate) >= k) >=
    ``alpha``."""
    if n == 0 or rate <= 0.0:
        return 0.0

    def log_pmf(i):
        return (math.lgamma(n + 1) - math.lgamma(i + 1) - math.lgamma(n - i + 1)
                + i * math.log(rate) + (n - i) * math.log1p(-rate))

    tail = 0.0
    for k in range(n, -1, -1):
        tail += math.exp(log_pmf(k))
        if tail >= alpha:
            return k / n
    return 0.0


def _gap(values, present, want, want_present) -> float:
    if values is None or present is None:
        return float("inf")
    present = np.asarray(present, bool)
    if present.shape != want_present.shape or (present != want_present).any():
        return float("inf")
    if not want_present.any():
        return 0.0
    return reference.relative_gap(np.asarray(values)[:, want_present],
                                  want[:, want_present])


def _miss(values, present, want, want_present, error: float) -> bool:
    if values is None or present is None:
        return True
    present = np.asarray(present, bool)
    if (want_present & ~present).any():
        return True
    cols = want_present
    if not cols.any():
        return False
    got, exp = np.asarray(values)[:, cols], want[:, cols]
    with np.errstate(invalid="ignore", divide="ignore"):
        rel = np.abs(got - exp) / np.abs(exp)
    return bool(np.any(~(rel <= error)))


def judge(answers: Sequence[Answer], ref: Reference,
          limits: Dict[str, float]) -> Dict[str, Dict[str, float]]:
    """The numbers of one run, each with its limit and how many answers it
    covers."""
    ref.prefetch([a.query for a in answers])
    exact_gap, n_exact = 0.0, 0
    sample_gap, n_sample = 0.0, 0
    distinct: Dict[tuple, bool] = {}
    confidence = 1.0
    for a in answers:
        if a.error is not None:
            continue
        want, want_present = ref.exact(a.query)
        if a.exact:
            n_exact += 1
            exact_gap = max(exact_gap, _gap(a.values, a.present, want, want_present))
            continue
        n_sample += 1
        gaps = [_gap(a.values, a.present, *ref.sample(a.query, s)) for s in a.samples]
        sample_gap = max(sample_gap, min(gaps, default=float("inf")))
        err, conf = a.query.guarantee
        confidence = min(confidence, conf / 100.0)
        key = (a.query.key, np.asarray(a.values).tobytes())
        if key not in distinct:
            distinct[key] = _miss(a.values, a.present, want, want_present, err / 100.0)
    misses = sum(distinct.values())
    return {
        "exact_gap": {"value": exact_gap, "limit": float(limits["exact_gap"]),
                      "answers": n_exact},
        "sample_gap": {"value": sample_gap, "limit": float(limits["sample_gap"]),
                       "answers": n_sample},
        "miss_share": {"value": misses / len(distinct) if distinct else 0.0,
                       "limit": miss_limit(len(distinct), 1.0 - confidence),
                       "answers": len(distinct)},
    }


def passed(checks: Dict[str, Dict[str, float]]) -> bool:
    return all(c["value"] <= c["limit"] for c in checks.values())


def control_answers(answers: Sequence[Answer], control: Reference) -> List[Answer]:
    """The control: the reference in the control's dtype put in the
    program's place -- each exact answer its exact value, each approximate
    answer its estimate over the program's own final sample, every table
    of it."""
    out = []
    for a in answers:
        if a.error is not None:
            out.append(a)
            continue
        if a.exact or not a.samples:
            v, p = control.exact(a.query)
        else:
            v, p = control.sample(a.query, a.samples[0])
        out.append(dataclasses.replace(a, values=v, present=p))
    return out
