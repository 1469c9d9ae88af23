"""granite-20b [dense]: 52L d6144 48H (MQA kv=1) dff24576 v49152.
[arXiv:2405.04324; hf] — llama-arch code model; extreme MQA (one KV head)."""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="granite-20b", family="dense", num_layers=52, d_model=6144,
    num_heads=48, num_kv_heads=1, head_dim=128, d_ff=24576, vocab_size=49152,
    mlp="swiglu",
).validate()
