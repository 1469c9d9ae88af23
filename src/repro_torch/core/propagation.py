"""Error propagation for composite aggregates (Table 2, Appendix B.3).

Upper bounds of the composite relative error given component errors e1, e2:

  product:  e1 + e2 + e1·e2
  division: (e1 + e2) / (1 − max(e1, e2))     [corrected — see below]
  addition: max(e1, e2)        (positive weights/components)

NOTE on division: the paper's Table 2 states (e1+e2)/(1+min(e1,e2)), but its
own Lemma B.3 derivation shows the two-sided interval
  −(e1+e2)/(1+e1) ≤ rel ≤ (e1+e2)/(1−e2),
whose worst absolute side is the RIGHT one; (e1+e2)/(1+min) takes the *left*
denominator and is violated when the denominator estimate errs low (found by
property-based testing: μ̂2 = μ2(1−e2) gives rel = (e1+e2)/(1−e2) > bound).
We use the valid bound (e1+e2)/(1−max(e1,e2)); both agree to O(e²), so
planned sampling rates change by ~e only.

TAQA splits a composite budget *evenly* across components (§3.1): the
component budget e' is the largest symmetric budget whose propagated bound
stays <= e.
"""

from __future__ import annotations

import math


def propagate_product(e1: float, e2: float) -> float:
    return e1 + e2 + e1 * e2


def propagate_division(e1: float, e2: float) -> float:
    m = max(e1, e2)
    if m >= 1.0:
        return math.inf
    return (e1 + e2) / (1.0 - m)


def propagate_addition(e1: float, e2: float) -> float:
    return max(e1, e2)


def split_budget(kind: str, e: float) -> float:
    """Even per-component budget e' such that propagate(e', e') <= e."""
    if kind in ("sum", "count"):
        return e
    if kind == "product":
        # e' + e' + e'^2 = e  =>  e' = sqrt(e+1) - 1  (§3.1)
        return math.sqrt(e + 1.0) - 1.0
    if kind in ("avg", "ratio"):
        # 2e'/(1-e') = e  =>  e' = e / (2 + e)   (corrected division rule)
        return e / (2.0 + e)
    if kind == "add":
        return e
    raise ValueError(kind)


def combine_estimates(kind: str, v1: float, v2: float | None,
                      weights=(1.0, 1.0)) -> float:
    if kind in ("sum", "count"):
        return v1
    if kind in ("avg", "ratio"):
        return v1 / v2 if v2 not in (0.0, None) else float("nan")
    if kind == "product":
        return v1 * v2
    if kind == "add":
        return weights[0] * v1 + weights[1] * v2
    raise ValueError(kind)
