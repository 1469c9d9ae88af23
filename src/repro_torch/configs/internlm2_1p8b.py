"""internlm2-1.8b [dense]: 24L d2048 16H (GQA kv=8) dff8192 v92544.
[arXiv:2403.17297; hf] — GQA llama-style decoder, SwiGLU, head_dim 128."""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="internlm2-1.8b", family="dense", num_layers=24, d_model=2048,
    num_heads=16, num_kv_heads=8, head_dim=128, d_ff=8192, vocab_size=92544,
    mlp="swiglu", rope_theta=1e6,
).validate()
