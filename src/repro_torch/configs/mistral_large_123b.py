"""mistral-large-123b [dense]: 88L d12288 96H (GQA kv=8) dff28672 v32768.
[hf:mistralai/Mistral-Large-Instruct-2407; unverified] — the memory-heavy
cell: FSDP+TP mandatory, scan+full remat."""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="mistral-large-123b", family="dense", num_layers=88, d_model=12288,
    num_heads=96, num_kv_heads=8, head_dim=128, d_ff=28672, vocab_size=32768,
    mlp="swiglu", rope_theta=1e6,
).validate()
