from repro_torch.kernels.block_agg.ops import block_agg
from repro_torch.kernels.block_agg.ref import block_agg_ref

__all__ = ["block_agg", "block_agg_ref"]
