"""llava-next-34b [vlm]: 60L d7168 56H (GQA kv=8) dff20480 v64000.
[hf:llava-hf/llava-v1.6-mistral-7b-hf; unverified]

Vision tower + anyres tiling are a STUB per the assignment: input_specs
provide 576 precomputed patch embeddings (B, 576, 7168) that are prepended
to the text tokens."""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="llava-next-34b", family="vlm", num_layers=60, d_model=7168,
    num_heads=56, num_kv_heads=8, head_dim=128, d_ff=20480, vocab_size=64000,
    mlp="swiglu", num_patches=576, rope_theta=5e6,
).validate()
