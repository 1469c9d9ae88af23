"""rwkv6-7b "Finch" [ssm, attention-free]: 32L d4096 dff14336 v65536 —
data-dependent per-channel decay. [arXiv:2404.05892; hf]

Realized as gated linear attention with 64 heads of dk=dv=64 and
data-dependent log-decay g_t = -softplus(xW+b) (the RWKV6 w_t); chunked
GEMM form for train/prefill (kernels/gla_chunk on TPU), O(1) recurrent
state for decode — long_500k runs with a (dk, dv) state per head."""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="rwkv6-7b", family="ssm", num_layers=32, d_model=4096,
    num_heads=0, num_kv_heads=0, head_dim=0, d_ff=14336, vocab_size=65536,
    mlp="swiglu", ssm_state=64, num_ssm_heads=64,
).validate()
