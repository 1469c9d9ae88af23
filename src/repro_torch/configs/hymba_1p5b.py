"""hymba-1.5b [hybrid]: 32L d1600 25H (GQA kv=5) dff5504 v32001,
ssm_state=16 — parallel attention + SSM heads. [arXiv:2411.13676; hf]

Simplifications noted in DESIGN.md: sliding-window attention (w=1024) on all
layers (the original keeps 3 global layers); the SSM branch carries global
context, which is what makes long_500k servable; attn/SSM outputs fused by
mean (original uses learned per-head norms); meta-tokens omitted."""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="hymba-1.5b", family="hybrid", num_layers=32, d_model=1600,
    num_heads=25, num_kv_heads=5, head_dim=64, d_ff=5504, vocab_size=32001,
    mlp="swiglu", ssm_state=16, num_ssm_heads=25, sliding_window=1024,
).validate()
