"""TAQA (two-stage online AQP, §3) and BSAP (block-sampling statistics with
a priori guarantees, §4): the host-side f64 statistics, copied from the
reference, and the two-stage driver over the port's engine."""

from repro_torch.core.spec import CompositeAgg, ErrorSpec, SamplingPlan
from repro_torch.core.taqa import (ApproxAnswer, PilotDB, Query, TaqaReport,
                                   build_engine_plan, structural_signature)
from repro_torch.core.quickr import RowSamplingAQP

__all__ = [
    "CompositeAgg",
    "ErrorSpec",
    "SamplingPlan",
    "ApproxAnswer",
    "PilotDB",
    "Query",
    "TaqaReport",
    "RowSamplingAQP",
    "build_engine_plan",
    "structural_signature",
]
