from repro_torch.kernels.filtered_agg.ops import filtered_agg, filtered_agg_batched
from repro_torch.kernels.filtered_agg.ref import (filtered_agg_batched_ref,
                                                  filtered_agg_ref)

__all__ = ["filtered_agg", "filtered_agg_batched", "filtered_agg_ref",
           "filtered_agg_batched_ref"]
