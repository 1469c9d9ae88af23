from repro_torch.kernels.flash_attn.ops import flash_attention
from repro_torch.kernels.flash_attn.ref import (attention_ref, flash_attention_bwd_ref,
                                                flash_attention_lse_ref,
                                                flash_attention_ref)

__all__ = ["attention_ref", "flash_attention", "flash_attention_bwd_ref",
           "flash_attention_lse_ref", "flash_attention_ref"]
