from repro_torch.kernels.gla_chunk.ops import gla_chunked
from repro_torch.kernels.gla_chunk.ref import (gla_chunked_bwd_ref, gla_chunked_fwd_ref,
                                               gla_chunked_ref, gla_recurrent_ref)

__all__ = ["gla_chunked", "gla_chunked_bwd_ref", "gla_chunked_fwd_ref",
           "gla_chunked_ref", "gla_recurrent_ref"]
