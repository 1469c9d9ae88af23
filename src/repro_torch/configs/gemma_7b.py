"""gemma-7b [dense]: 28L d3072 16H (kv=16) dff24576 v256000, GeGLU,
head_dim=256 (q_dim 4096 != d_model). [arXiv:2403.08295; hf]"""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="gemma-7b", family="dense", num_layers=28, d_model=3072,
    num_heads=16, num_kv_heads=16, head_dim=256, d_ff=24576,
    vocab_size=256000, mlp="geglu",
).validate()
