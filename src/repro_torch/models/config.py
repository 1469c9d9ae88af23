"""Model configuration covering all assigned architecture families.

One config type drives dense GQA decoders, MoE decoders, attention-free
linear-attention (RWKV6), hybrid attn+SSM (hymba), encoder-decoder audio
(whisper) and VLM (llava) backbones.  Frontends for [audio]/[vlm] are stubs
per the assignment: input_specs feed precomputed frame/patch embeddings.
"""

from __future__ import annotations

import dataclasses
from typing import Optional


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str                 # dense | moe | ssm | hybrid | encdec | vlm
    num_layers: int
    d_model: int
    num_heads: int
    num_kv_heads: int
    head_dim: int
    d_ff: int
    vocab_size: int
    mlp: str = "swiglu"         # swiglu | geglu
    # MoE
    num_experts: int = 0
    top_k: int = 0
    capacity_factor: float = 1.25
    # linear attention / SSM
    ssm_state: int = 0          # key/state dim per linear-attention head
    num_ssm_heads: int = 0
    gla_impl: str = "dif"       # dif | subblock (see models.linear_attn)
    moe_chunk: int = 0          # >0: process MoE FFN in token chunks (memory)
    moe_dense_train: bool = False  # dense-all-experts compute (no dispatch)
    remat_groups: int = 0       # >1: two-level (sqrt) remat over layer groups
    # hybrid (hymba): parallel attention + SSM heads; sliding-window attn
    sliding_window: int = 0     # 0 = full attention
    # encoder-decoder (whisper)
    encoder_layers: int = 0
    enc_seq: int = 0            # stub frontend length (precomputed frames)
    # VLM (llava)
    num_patches: int = 0        # stub frontend patch-embedding count
    rope_theta: float = 1e4
    norm_eps: float = 1e-5
    dtype: str = "bfloat16"
    remat: bool = True
    scan_layers: bool = True
    # serving
    max_decode_len: int = 32768

    @property
    def attn_free(self) -> bool:
        return self.family == "ssm"

    @property
    def has_attention(self) -> bool:
        return self.family != "ssm"

    @property
    def has_ssm(self) -> bool:
        return self.family in ("ssm", "hybrid")

    @property
    def is_moe(self) -> bool:
        return self.num_experts > 0

    @property
    def q_dim(self) -> int:
        return self.num_heads * self.head_dim

    @property
    def kv_dim(self) -> int:
        return self.num_kv_heads * self.head_dim

    @property
    def sub_quadratic(self) -> bool:
        """Can this arch serve 500k-token contexts?  SSM state is O(1); a
        sliding window bounds the cache.  Pure full attention cannot."""
        return self.family == "ssm" or (
            self.family == "hybrid" and self.sliding_window > 0)

    def validate(self):
        assert self.num_layers > 0 and self.d_model > 0
        if self.has_attention:
            assert self.num_heads % max(self.num_kv_heads, 1) == 0
        if self.is_moe:
            assert 0 < self.top_k <= self.num_experts
        if self.family == "encdec":
            assert self.encoder_layers > 0 and self.enc_seq > 0
        if self.family == "vlm":
            assert self.num_patches > 0
        if self.has_ssm:
            assert self.ssm_state > 0 and self.num_ssm_heads > 0
        return self

    def reduced(self, **overrides) -> "ModelConfig":
        """A small same-family config for CPU smoke tests."""
        small = dict(
            num_layers=2,
            d_model=64,
            num_heads=4,
            num_kv_heads=max(1, min(self.num_kv_heads, 2)),
            head_dim=16,
            d_ff=128,
            vocab_size=256,
            num_experts=min(self.num_experts, 4),
            top_k=min(self.top_k, 2),
            ssm_state=min(self.ssm_state, 8) if self.ssm_state else 0,
            num_ssm_heads=4 if self.num_ssm_heads else 0,
            sliding_window=min(self.sliding_window, 16) if self.sliding_window else 0,
            encoder_layers=2 if self.encoder_layers else 0,
            enc_seq=24 if self.enc_seq else 0,
            num_patches=8 if self.num_patches else 0,
            dtype="float32",
            max_decode_len=64,
        )
        small.update(overrides)
        return dataclasses.replace(self, **small).validate()
