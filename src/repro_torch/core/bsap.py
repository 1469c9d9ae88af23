"""BSAP — Block SAmpling with a Priori guarantees (§4, Appendix B).

Everything here consumes only *per-block* (or per-block-pair) pilot sums:
that is the whole point of the sampling-equivalence rules (Props. 4.4–4.6 /
Eq. 8) — after normalization, any supported query's estimator statistics are
functions of block-level aggregate contributions of the sampled base tables.

Estimator conventions (must match repro_torch.engine.executor's upscaling):

* single sampled table — Hájek total μ̂ = N·ȳ_S; conditional-on-n SRS
  analysis (Lemma B.1 at block granularity: chi² bound on σ_b², binomial
  bound on n).  This is the paper's Lemma B.1 pipeline and avoids the
  sample-size noise that dominates the plain HT total under Bernoulli
  sampling (cf. §5.5's fixed-size comparison).
* two sampled tables — Horvitz–Thompson μ̂ = (1/(θ1θ2))ΣΣ J, whose exact
  variance expansion is Lemma 4.8's three-term form.
"""

from __future__ import annotations

import math
from typing import Callable, Optional

import numpy as np

from repro_torch.stats import (
    binomial_lower_bound,
    chi2_ppf,
    normal_ppf,
    population_lower_bound,
    student_t_ppf,
)

# ---------------------------------------------------------------------------
# Student-t bounds on population block sums (the U_y[δ] of Lemma 4.8)
# ---------------------------------------------------------------------------


def t_bound_sum(y: np.ndarray, n_total: int, delta: float, side: str) -> float:
    """Probabilistic bound of the population total Σ_{i=1..N} y_i from a
    Bernoulli pilot sample of blocks.

    The paper's Lemma 4.8 writes U_y[δ] = (1/θ_p)(Σ_pilot y + √n σ̂ t), whose
    spread term is the conditional-SRS one; the (1/θ_p)Σ scaling however adds
    Bernoulli sample-*size* noise (∝ μ_y²) that the spread does not cover, so
    the printed bound under-covers whenever |ȳ| ≫ σ̂(y) (we measured 83% at a
    nominal 95%).  Our catalog knows N exactly, so we use the Hájek form

      U_y[δ] = N·(ȳ_p + t_{1-δ,n_p-1}·σ̂(y)/√n_p)

    which is the same quantity conditioned on n_p — and the conditional
    analysis is exact for Bernoulli sampling (given its size, the sample is
    SRS).  Coverage is restored (validated in tests/test_bsap.py).
    """
    y = np.asarray(y, dtype=np.float64)
    n_p = y.shape[0]
    if n_p < 2:
        return math.inf if side == "upper" else -math.inf
    t = student_t_ppf(1.0 - delta, n_p - 1)
    spread = t * float(y.std(ddof=1)) / math.sqrt(n_p)
    if side == "upper":
        return n_total * (float(y.mean()) + spread)
    return n_total * (float(y.mean()) - spread)


def upper_sum(y, n_total, delta):
    return t_bound_sum(y, n_total, delta, "upper")


def lower_sum(y, n_total, delta):
    return t_bound_sum(y, n_total, delta, "lower")


# ---------------------------------------------------------------------------
# Single-table bounds (Lemma B.1 with blocks as the sampling unit)
# ---------------------------------------------------------------------------
#
# Estimator convention for single-table plans: the final query estimates the
# population TOTAL with the Hájek form  μ̂ = N · ȳ_S  (N exact from catalog
# metadata, ȳ_S the mean block contribution among the n sampled blocks).
# Conditioned on its size, a Bernoulli sample is a simple random sample, so
#   Var[μ̂ | n] = N² (1−θ) σ_b² / n,
# with σ_b² bounded by the chi-squared bound and n by the binomial bound —
# exactly the paper's Lemma B.1 pipeline, at block granularity.  This avoids
# the sample-size noise that dominates the plain HT total (1/θ)Σ and matches
# the paper's observation that Bernoulli costs only a few % versus fixed-size
# sampling (§5.5), not a constant factor.


def block_mean_lower(y: np.ndarray, delta1: float) -> float:
    """L of the population block mean:  ȳ_p − t_{1−δ1} σ̂_p/√n_p."""
    y = np.asarray(y, dtype=np.float64)
    n_p = y.shape[0]
    if n_p < 2:
        return -math.inf
    t = student_t_ppf(1.0 - delta1, n_p - 1)
    return float(y.mean()) - t * float(y.std(ddof=1)) / math.sqrt(n_p)


def single_table_var_ub(y: np.ndarray, theta_p: float, delta2: float,
                        n_blocks: Optional[int] = None) -> Callable[[float], float]:
    """U_V[θ]: variance bound of the total estimator N·ȳ_S (Lemma B.1).

    δ2 is split across the probabilistic bounds used: chi-squared (σ_b²),
    binomial (final sample size n), and — when N must itself be estimated
    from the pilot (``n_blocks=None``) — the population bound L_N.
    """
    y = np.asarray(y, dtype=np.float64)
    n_p = y.shape[0]
    if n_p < 2:
        return lambda theta: math.inf
    parts = 2.0 if n_blocks is not None else 3.0
    chi = chi2_ppf(delta2 / parts, n_p - 1)
    var_ub = (n_p - 1) / max(chi, 1e-12) * float(y.var(ddof=1))
    if n_blocks is not None:
        N = float(n_blocks)
    else:
        N = population_lower_bound(n_p, theta_p, delta2 / parts)

    def U_V(theta: float) -> float:
        if theta >= 1.0:
            return 0.0
        n_lb = binomial_lower_bound(N, theta, delta2 / parts)
        if n_lb <= 1.0:
            return math.inf
        return N * N * (1.0 - theta) * var_ub / n_lb

    return U_V


# ---------------------------------------------------------------------------
# Two-table join variance bound (Lemma 4.8)
# ---------------------------------------------------------------------------

def join_var_ub(pair: np.ndarray, n1_total: int,
                delta2: float) -> Callable[[float, float], float]:
    """U_V[Θ] for SUM over a join with block sampling on both tables.

    ``pair``: (n_p, N2) — J(t_{1,i}, t_{2,i2}) block-pair sums from a pilot
    that sampled T_1 (T_2 fully scanned, so its block sums are exact *given*
    the sampled T_1 blocks).  ``n1_total`` = N1, T_1's total block count.

    Lemma 4.8, with δ' = δ2/(N2+2):
      U_V[θ1,θ2] = (1-θ1)/θ1 · U_{y⁽¹⁾}[δ']
                 + (1-θ2)/θ2 · Σ_{i2} (U_{y⁽²⁾_{i2}}[δ'])²
                 + (1-θ1)(1-θ2)/(θ1 θ2) · U_{y⁽³⁾}[δ']
    (population sums over T_1 bounded with the Hájek t-form, see t_bound_sum).
    """
    pair = np.asarray(pair, dtype=np.float64)
    n_p, n2 = pair.shape
    dprime = delta2 / (n2 + 2.0)

    y1 = np.square(pair.sum(axis=1))          # (n_p,)
    y3 = np.square(pair).sum(axis=1)          # (n_p,)
    u_y1 = max(upper_sum(y1, n1_total, dprime), 0.0)
    u_y3 = max(upper_sum(y3, n1_total, dprime), 0.0)
    # Per-i2 column sums over ALL T1 blocks, bounded from the pilot.
    u_cols = np.zeros(n2)
    if n_p >= 2:
        t = student_t_ppf(1.0 - dprime, n_p - 1)
        col_mean = pair.mean(axis=0)
        col_std = pair.std(axis=0, ddof=1)
        u_cols = n1_total * (col_mean + t * col_std / math.sqrt(n_p))
    sum_u_cols_sq = float(np.square(np.maximum(u_cols, 0.0)).sum())

    def U_V(theta1: float, theta2: float) -> float:
        v = 0.0
        if theta1 < 1.0:
            v += (1.0 - theta1) / theta1 * u_y1
        if theta2 < 1.0:
            v += (1.0 - theta2) / theta2 * sum_u_cols_sq
        if theta1 < 1.0 and theta2 < 1.0:
            v += (1.0 - theta1) * (1.0 - theta2) / (theta1 * theta2) * u_y3
        return v

    return U_V


# ---------------------------------------------------------------------------
# Group coverage (Lemma 3.2)
# ---------------------------------------------------------------------------

def group_coverage_rate(num_blocks: int, block_rows: int, group_min_size: int,
                        miss_prob: float) -> float:
    """Minimum block-sampling rate θ such that every group of >= g rows
    survives with probability >= 1 - p_f (Lemma 3.2 / B.5)."""
    n0 = max(int(math.ceil(group_min_size / block_rows)), 1)
    if num_blocks <= n0:
        return 1.0
    inner = 1.0 - (1.0 - miss_prob) ** (n0 / num_blocks)
    theta = 1.0 - inner ** (1.0 / n0)
    return min(max(theta, 0.0), 1.0)


def group_miss_prob_ub(theta: float, num_blocks: int, block_rows: int,
                       group_min_size: int) -> float:
    """Inverse of Lemma 3.2: upper bound on P[miss any group of size >= g]."""
    n0 = max(int(math.ceil(group_min_size / block_rows)), 1)
    include_all = (1.0 - (1.0 - theta) ** n0) ** (num_blocks / n0)
    return 1.0 - include_all


# ---------------------------------------------------------------------------
# Statistical efficiency (Lemma 4.1)
# ---------------------------------------------------------------------------

def efficiency_ratio(values: np.ndarray, block_rows: int) -> float:
    """b · (1 − E[σ_j²]/Var[X]) — ratio of block-sample rows to row-sample
    rows needed for equal accuracy.  < 1 ⇒ block sampling needs FEWER rows."""
    values = np.asarray(values, dtype=np.float64)
    n = (len(values) // block_rows) * block_rows
    blocks = values[:n].reshape(-1, block_rows)
    within = blocks.var(axis=1, ddof=0).mean()
    total = values[:n].var(ddof=0)
    if total <= 0:
        return 0.0
    return block_rows * (1.0 - within / total)


# ---------------------------------------------------------------------------
# Row-level naive CLT machinery (Lemma B.1) — the Appendix-A.1 baseline that
# BSAP replaces, and the row-level path for PilotDB-R / Quickr ablations.
# ---------------------------------------------------------------------------

def naive_row_bounds(mean_p: float, var_p: float, n_p: int, theta_p: float,
                     delta1: float, delta2: float, exact_N: float | None = None):
    """Returns (L_mu_mean, U_V(theta)) treating pilot rows as i.i.d. (invalid
    under block sampling — that is the point of Fig. 16/17).

    L_mu is a lower bound of the population *mean*; U_V(theta) bounds the
    variance of the final sample mean with row rate theta (Lemma B.1).
    """
    if n_p < 2:
        return -math.inf, lambda theta: math.inf
    sd_p = math.sqrt(max(var_p, 0.0))
    t = student_t_ppf(1.0 - delta1, n_p - 1)
    L_mu = mean_p - t * sd_p / math.sqrt(n_p)

    chi = chi2_ppf(delta2 / 3.0, n_p - 1)
    var_ub = (n_p - 1) / max(chi, 1e-12) * max(var_p, 0.0)
    L_N = exact_N if exact_N is not None else population_lower_bound(
        n_p, theta_p, delta2 / 3.0)

    def U_V(theta: float) -> float:
        n_lb = binomial_lower_bound(L_N, theta, delta2 / 3.0)
        if n_lb <= 1:
            return math.inf
        return var_ub / n_lb

    return L_mu, U_V


# ---------------------------------------------------------------------------
# The per-aggregate constraint φ (§3.2) and the adjusted-confidence z value
# ---------------------------------------------------------------------------

def z_for(p_prime: float) -> float:
    p_prime = min(p_prime, 1.0 - 1e-12)
    return normal_ppf((1.0 + p_prime) / 2.0)


def phi_satisfied(z: float, U_V: float, L_mu: float, e: float) -> bool:
    """φ(Θ) ≡ z·sqrt(U_V[Θ])/L_μ <= e (Inequality 6)."""
    if L_mu <= 0.0 or not math.isfinite(U_V):
        return False
    return z * math.sqrt(max(U_V, 0.0)) / L_mu <= e
