"""Distribution percentiles used by TAQA/BSAP (Appendix B.1 of the paper).

TAQA needs three percentile functions: standard normal ``z``, Student's t, and
chi-squared.  We use scipy when available (it is a pure-host dependency — the
planner runs on host, never inside a jitted graph) and fall back to published
closed-form approximations otherwise, so the middleware deploys with only
numpy installed.

Accuracy of the fallbacks (validated in tests/test_distributions.py):
  * normal_ppf: Acklam's rational approximation, |err| < 1.2e-8.
  * student_t_ppf: Hill (1970) Cornish-Fisher expansion, rel err < 1e-3 for
    df >= 5 (TAQA requires pilot samples of n >= 30, see §3.1).
  * chi2_ppf: Wilson–Hilferty cube approximation, rel err < 1e-2 for df >= 20.

Each of the three percentile functions counts its calls per thread
(:func:`ppf_calls`), so a rate solve can report how many it made however
many solves run on other threads.
"""

from __future__ import annotations

import math
import threading

import numpy as np

try:  # pragma: no cover - environment dependent
    from scipy import stats as _sps

    _HAVE_SCIPY = True
except Exception:  # pragma: no cover
    _sps = None
    _HAVE_SCIPY = False

_CALLS = threading.local()


def ppf_calls() -> int:
    """Percentile evaluations made so far on the calling thread (a running
    count: callers read it before and after the work they measure)."""
    return getattr(_CALLS, "n", 0)


def _count() -> None:
    try:
        _CALLS.n += 1
    except AttributeError:  # the thread's first percentile call
        _CALLS.n = 1


# ---------------------------------------------------------------------------
# Normal
# ---------------------------------------------------------------------------

# Acklam's inverse-normal-CDF coefficients.
_A = (-3.969683028665376e01, 2.209460984245205e02, -2.759285104469687e02,
      1.383577518672690e02, -3.066479806614716e01, 2.506628277459239e00)
_B = (-5.447609879822406e01, 1.615858368580409e02, -1.556989798598866e02,
      6.680131188771972e01, -1.328068155288572e01)
_C = (-7.784894002430293e-03, -3.223964580411365e-01, -2.400758277161838e00,
      -2.549732539343734e00, 4.374664141464968e00, 2.938163982698783e00)
_D = (7.784695709041462e-03, 3.224671290700398e-01, 2.445134137142996e00,
      3.754408661907416e00)


def _acklam(p: float) -> float:
    if not 0.0 < p < 1.0:
        raise ValueError(f"p must be in (0, 1), got {p}")
    p_low, p_high = 0.02425, 1 - 0.02425
    if p < p_low:
        q = math.sqrt(-2 * math.log(p))
        return (((((_C[0] * q + _C[1]) * q + _C[2]) * q + _C[3]) * q + _C[4]) * q + _C[5]) / \
            ((((_D[0] * q + _D[1]) * q + _D[2]) * q + _D[3]) * q + 1)
    if p > p_high:
        q = math.sqrt(-2 * math.log(1 - p))
        return -(((((_C[0] * q + _C[1]) * q + _C[2]) * q + _C[3]) * q + _C[4]) * q + _C[5]) / \
            ((((_D[0] * q + _D[1]) * q + _D[2]) * q + _D[3]) * q + 1)
    q = p - 0.5
    r = q * q
    return (((((_A[0] * r + _A[1]) * r + _A[2]) * r + _A[3]) * r + _A[4]) * r + _A[5]) * q / \
        (((((_B[0] * r + _B[1]) * r + _B[2]) * r + _B[3]) * r + _B[4]) * r + 1)


def normal_ppf(p: float) -> float:
    """Percentile of the standard normal distribution (z_{p})."""
    _count()
    if _HAVE_SCIPY:
        return float(_sps.norm.ppf(p))
    return _acklam(p)


# ---------------------------------------------------------------------------
# Student's t
# ---------------------------------------------------------------------------

def student_t_ppf(p: float, df: float) -> float:
    """Percentile t_{df, p} of Student's t distribution."""
    _count()
    if df <= 0:
        raise ValueError("df must be positive")
    if _HAVE_SCIPY:
        return float(_sps.t.ppf(p, df))
    # Hill's Cornish-Fisher style expansion around the normal percentile.
    z = _acklam(p)
    g1 = (z ** 3 + z) / 4.0
    g2 = (5 * z ** 5 + 16 * z ** 3 + 3 * z) / 96.0
    g3 = (3 * z ** 7 + 19 * z ** 5 + 17 * z ** 3 - 15 * z) / 384.0
    g4 = (79 * z ** 9 + 776 * z ** 7 + 1482 * z ** 5 - 1920 * z ** 3 - 945 * z) / 92160.0
    return float(z + g1 / df + g2 / df ** 2 + g3 / df ** 3 + g4 / df ** 4)


# ---------------------------------------------------------------------------
# Chi-squared
# ---------------------------------------------------------------------------

def chi2_ppf(p: float, df: float) -> float:
    """Percentile chi2_{df, p}."""
    _count()
    if df <= 0:
        raise ValueError("df must be positive")
    if _HAVE_SCIPY:
        return float(_sps.chi2.ppf(p, df))
    # Wilson–Hilferty: chi2 ~ df * (1 - 2/(9 df) + z sqrt(2/(9 df)))^3
    z = _acklam(p)
    k = 2.0 / (9.0 * df)
    return float(df * (1.0 - k + z * math.sqrt(k)) ** 3)


# ---------------------------------------------------------------------------
# Binomial / population-size bounds (Lemma B.1 machinery)
# ---------------------------------------------------------------------------

def binomial_lower_bound(n_units: float, theta: float, delta: float) -> float:
    """Probabilistic lower bound on a Bin(n_units, theta) sample size.

    Normal approximation (Ineq. 12 of the paper):
      P[n >= N*theta - z_{1-delta} sqrt(N theta (1-theta))] >= 1 - delta.
    Clamped below at 0.
    """
    if n_units <= 0:
        return 0.0
    z = normal_ppf(1.0 - delta)
    lo = n_units * theta - z * math.sqrt(max(n_units * theta * (1.0 - theta), 0.0))
    return max(lo, 0.0)


def population_lower_bound(n_pilot: float, theta_p: float, delta: float) -> float:
    """Probabilistic lower bound L_N of the population size N (Ineq. 13).

    From n_p <= N*theta_p + z sqrt(N theta_p (1-theta_p)) w.p. >= 1-delta,
      sqrt(N) >= sqrt(n_p/theta_p + z^2 (1-theta_p)/(4 theta_p))
                 - sqrt(z^2 (1-theta_p)/(4 theta_p)).
    """
    if n_pilot <= 0:
        return 0.0
    z = normal_ppf(1.0 - delta)
    c = z * z * (1.0 - theta_p) / (4.0 * theta_p)
    root = math.sqrt(n_pilot / theta_p + c) - math.sqrt(c)
    return max(root * root, 0.0)
