from repro_torch.kernels.filtered_agg.ops import filtered_agg
from repro_torch.kernels.filtered_agg.ref import filtered_agg_ref

__all__ = ["filtered_agg", "filtered_agg_ref"]
