"""olmoe-1b-7b [moe]: 16L d2048 16H (kv=16) dff1024/expert, v50304,
64 experts top-8. [arXiv:2409.02060; hf]"""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="olmoe-1b-7b", family="moe", num_layers=16, d_model=2048,
    num_heads=16, num_kv_heads=16, head_dim=128, d_ff=1024, vocab_size=50304,
    mlp="swiglu", num_experts=64, top_k=8,
).validate()
