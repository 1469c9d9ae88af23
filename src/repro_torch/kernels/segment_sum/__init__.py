from repro_torch.kernels.segment_sum.ops import segment_sum
from repro_torch.kernels.segment_sum.ref import segment_sum_ref

__all__ = ["segment_sum", "segment_sum_ref"]
