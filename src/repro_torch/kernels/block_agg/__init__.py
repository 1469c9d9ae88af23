from repro_torch.kernels.block_agg.ops import block_agg, block_agg_batched
from repro_torch.kernels.block_agg.ref import block_agg_batched_ref, block_agg_ref

__all__ = ["block_agg", "block_agg_batched", "block_agg_ref",
           "block_agg_batched_ref"]
