from repro_torch.stats.distributions import (
    normal_ppf,
    student_t_ppf,
    chi2_ppf,
    ppf_calls,
    binomial_lower_bound,
    population_lower_bound,
)

__all__ = [
    "normal_ppf",
    "student_t_ppf",
    "chi2_ppf",
    "ppf_calls",
    "binomial_lower_bound",
    "population_lower_bound",
]
