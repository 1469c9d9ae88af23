"""Confidence allocation across aggregates, groups, and probabilistic bounds.

§2.4's guarantee is a *joint* probability over k·m (aggregate × group) events.
TAQA decomposes it with Boole's inequality (§3.1 "Multi-Aggregate Queries"):
with C total simple-channel constraints each allocated confidence
p_c = 1 − (1−p)/C, the joint holds at p.  Within each channel, Procedure 1
spends δ1 (for L_μ) and δ2 (for U_V) and inflates the CLT confidence to
p' = p_c + δ1 + δ2 (Theorem 3.1), default δ1 = δ2 = (1−p_c)/3.

If Lemma 3.2's group-coverage bound is in play, its failure probability p_f
is a further Boole term: the user-facing confidence p is first debited by
p_f before channel allocation (conservative; the paper treats coverage as a
separate high-probability event).
"""

from __future__ import annotations

import dataclasses


@dataclasses.dataclass(frozen=True)
class ChannelBudget:
    error: float        # relative-error budget e for this simple channel
    confidence: float   # p_c allocated by Boole
    delta1: float       # failure prob of the L_mu bound
    delta2: float       # failure prob of the U_V bound
    p_prime: float      # adjusted CLT confidence (Thm 3.1)


def allocate(total_confidence: float, num_channels: int, channel_error: float,
             delta_split: tuple[float, float] | None = None,
             coverage_debit: float = 0.0) -> ChannelBudget:
    """Allocate confidence for one of ``num_channels`` simple constraints."""
    if num_channels < 1:
        raise ValueError(num_channels)
    p_eff = total_confidence + coverage_debit  # debit: need stronger base
    if p_eff >= 1.0:
        raise ValueError(
            f"confidence {total_confidence} + coverage debit {coverage_debit} "
            "is unattainable (>= 1)")
    p_c = 1.0 - (1.0 - p_eff) / num_channels
    if delta_split is None:
        d1 = d2 = (1.0 - p_c) / 3.0
    else:
        d1, d2 = delta_split
        if d1 + d2 >= 1.0 - p_c:
            raise ValueError("delta1 + delta2 must be < 1 - p_c")
    p_prime = p_c + d1 + d2
    return ChannelBudget(error=channel_error, confidence=p_c,
                         delta1=d1, delta2=d2, p_prime=p_prime)
