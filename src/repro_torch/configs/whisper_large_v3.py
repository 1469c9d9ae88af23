"""whisper-large-v3 [audio enc-dec]: 32L enc + 32L dec, d1280 20H kv=20
dff5120 v51866. [arXiv:2212.04356; unverified]

Conv/mel frontend is a STUB per the assignment: input_specs provide
precomputed frame embeddings (B, 1500, 1280).  Positional scheme unified to
RoPE (the original uses sinusoidal/learned) — noted in DESIGN.md."""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="whisper-large-v3", family="encdec", num_layers=32, d_model=1280,
    num_heads=20, num_kv_heads=20, head_dim=64, d_ff=5120, vocab_size=51866,
    mlp="swiglu", encoder_layers=32, enc_seq=1500,
).validate()
