"""User-facing specifications (§2.4) and sampling plans (§3.1)."""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Tuple

from repro_torch.engine.expr import Expr

COMPOSITE_KINDS = ("sum", "count", "avg", "ratio", "product", "add")


@dataclasses.dataclass(frozen=True)
class CompositeAgg:
    """A user-level aggregate, possibly a composite of simple SUM/COUNT parts.

    kind:
      sum / count — simple linear aggregates (one channel)
      avg         — SUM(expr)/COUNT(*)              (division rule, Table 2)
      ratio       — SUM(expr)/SUM(expr2)            (division rule)
      product     — SUM(expr)*SUM(expr2)            (multiplication rule)
      add         — w1*SUM(expr)+w2*SUM(expr2)      (addition rule)
    """

    name: str
    kind: str
    expr: Optional[Expr] = None
    expr2: Optional[Expr] = None
    weights: Tuple[float, float] = (1.0, 1.0)

    def __post_init__(self):
        if self.kind not in COMPOSITE_KINDS:
            raise ValueError(self.kind)
        if self.kind != "count" and self.expr is None:
            raise ValueError(f"{self.kind} needs expr")
        if self.kind in ("ratio", "product", "add") and self.expr2 is None:
            raise ValueError(f"{self.kind} needs expr2")

    @property
    def num_channels(self) -> int:
        return 1 if self.kind in ("sum", "count") else 2


@dataclasses.dataclass(frozen=True)
class ErrorSpec:
    """ERROR e% CONFIDENCE p% (§2.4) plus TAQA's tunables (§3.1).

    The guarantee is joint over all aggregates and groups (Eq. 1):
      P[ ∀ i,j : |rel err of mu_ij| <= error ] >= confidence.
    """

    error: float
    confidence: float
    group_min_size: int = 200        # g in Lemma 3.2
    group_miss_prob: float = 0.05    # p_f in Lemma 3.2
    theta_pilot: float = 0.0005      # default pilot rate theta_p
    min_pilot_blocks: int = 30       # ">30 units" recommendation (§3.1)
    max_final_rate: float = 0.10     # sampling-plan domain bound (§3.2)
    max_pilot_rate: float = 0.05     # cap on theta_p (pilot must stay cheap)
    # Lemma 3.2's theta can approach 1 when protected groups span few blocks
    # (its union bound covers every *hypothetical* group).  If the lemma rate
    # exceeds max_pilot_rate: strict mode executes exactly (coverage formally
    # guaranteed); default mode caps theta_p and flags the report, matching
    # the paper's empirical setting where real groups are block-plentiful.
    strict_group_coverage: bool = False

    def __post_init__(self):
        if not 0.0 < self.error < 1.0:
            raise ValueError("error must be in (0,1)")
        if not 0.0 < self.confidence < 1.0:
            raise ValueError("confidence must be in (0,1)")


@dataclasses.dataclass
class SamplingPlan:
    """Theta = [theta_1..theta_k]: block-sampling rate per sampled table."""

    rates: Dict[str, float]
    est_cost: float = 0.0

    def tables(self):
        return [t for t, r in self.rates.items() if r < 1.0]
