"""Config-driven decoder of the port: the forward of the reference's
``models/model.py`` for the families ``dense``, ``ssm`` and ``hybrid``.

Layer parameters are stacked on a leading L axis, as the reference stacks
them for its layer scan (``scan_layers=True``), so its parameter tree maps
one to one onto this module's state (``convert.model_params_from_arrays``);
the forward walks the layers in a Python loop.  Attention goes through the
flash wrapper, the SSM branch through the gla_chunk wrapper: the
hand-written kernels on the card, their plain versions on the CPU.  The
reference's ``remat``, ``scan`` and ``shard_hints`` are JAX/TPU machinery
with no counterpart on one card without a backward pass.
"""

from __future__ import annotations

from typing import Dict, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from repro_torch.device import resolve_device
from repro_torch.models.config import ModelConfig
from repro_torch.models.layers import mea_attention, mlp_block, rms_norm, rope
from repro_torch.models.linear_attn import gla_chunked

VOCAB_PAD = 128
FAMILIES = ("dense", "ssm", "hybrid")


def _dt(cfg: ModelConfig) -> torch.dtype:
    return torch.bfloat16 if cfg.dtype == "bfloat16" else torch.float32


def padded_vocab(cfg: ModelConfig) -> int:
    return ((cfg.vocab_size + VOCAB_PAD - 1) // VOCAB_PAD) * VOCAB_PAD


def _ssm_dv(cfg: ModelConfig) -> int:
    if cfg.family == "ssm":
        return cfg.d_model // cfg.num_ssm_heads
    return cfg.head_dim


def layer_shapes(cfg: ModelConfig) -> Dict[str, Tuple[int, ...]]:
    """One decoder layer's parameter shapes (the reference's
    ``Model._layer_shapes`` for the ported families)."""
    d, qd, kvd, f = cfg.d_model, cfg.q_dim, cfg.kv_dim, cfg.d_ff
    shapes: Dict[str, Tuple[int, ...]] = {"ln1": (d,), "ln2": (d,)}
    if cfg.has_attention:
        shapes.update(wq=(d, qd), wk=(d, kvd), wv=(d, kvd), wo=(qd, d))
    if cfg.has_ssm:
        nh, dk, dv = cfg.num_ssm_heads, cfg.ssm_state, _ssm_dv(cfg)
        shapes.update(s_wq=(d, nh * dk), s_wk=(d, nh * dk),
                      s_wv=(d, nh * dv), s_wg=(d, nh * dk),
                      s_gbias=(nh * dk,), s_wo=(nh * dv, d))
    shapes.update(w1=(d, f), w3=(d, f), w2=(f, d))
    return shapes


class Model(nn.Module):
    """Inference-only decoder on ``device`` (the card by default; raises
    without one unless ``device="cpu"``), parameters in ``cfg.dtype``.
    Allocated empty: call :meth:`init` or load a state dict."""

    def __init__(self, cfg: ModelConfig, device="cuda"):
        super().__init__()
        cfg.validate()
        if cfg.family not in FAMILIES or cfg.is_moe:
            what = {"moe": "moe.py (mixture-of-experts FFN)",
                    "encdec": "the encoder-decoder family",
                    "vlm": "the VLM family"}.get(cfg.family, cfg.family)
            raise NotImplementedError(
                f"{cfg.name}: {what} is not ported yet (ROADMAP queue 1 item "
                f"14); the port runs the families {FAMILIES}")
        self.cfg = cfg
        dev = resolve_device(device)
        dt = _dt(cfg)

        def empty(*shape):
            return nn.Parameter(torch.empty(shape, dtype=dt, device=dev),
                                requires_grad=False)

        vp = padded_vocab(cfg)
        self.embed = empty(vp, cfg.d_model)
        self.layers = nn.ParameterDict(
            {name: empty(cfg.num_layers, *shp)
             for name, shp in sorted(layer_shapes(cfg).items())})
        self.final_norm = empty(cfg.d_model)
        self.head = empty(cfg.d_model, vp)

    @torch.no_grad()
    def init(self, generator: torch.Generator) -> "Model":
        """Random weights from ``generator`` with the reference's
        distributions (``model.py`` ``_init_stack`` / ``init``): norms 0,
        ``s_gbias`` -1, matrices N(0, 1) * fan_in^-0.5, vectors N(0, 1) *
        0.02, the embedding N(0, 1) * 0.02, the head N(0, 1) * d^-0.5.
        Drawn in f32 on the generator's device, then cast and copied."""
        def normal(p: torch.Tensor, scale: float) -> None:
            x = torch.randn(p.shape, generator=generator, dtype=torch.float32,
                            device=generator.device)
            p.copy_(x.mul_(scale))

        normal(self.embed, 0.02)
        for name, p in self.layers.items():
            shp = p.shape[1:]
            if name.startswith("ln"):
                p.zero_()
            elif name == "s_gbias":
                p.fill_(-1.0)
            else:
                fan_in = shp[-2] if len(shp) >= 2 else shp[-1]
                normal(p, 0.02 if len(shp) < 2 else fan_in ** -0.5)
        self.final_norm.zero_()
        normal(self.head, self.cfg.d_model ** -0.5)
        return self

    # ------------------------------------------------------------- the block
    def _attn_branch(self, p, h, *, window: int):
        cfg = self.cfg
        b, s, _ = h.shape
        q = (h @ p["wq"]).view(b, s, cfg.num_heads, cfg.head_dim)
        k = (h @ p["wk"]).view(b, s, cfg.num_kv_heads, cfg.head_dim)
        v = (h @ p["wv"]).view(b, s, cfg.num_kv_heads, cfg.head_dim)
        pos = torch.arange(s, device=h.device)
        q = rope(q.transpose(1, 2), pos, cfg.rope_theta)
        k = rope(k.transpose(1, 2), pos, cfg.rope_theta)
        o = mea_attention(q, k, v.transpose(1, 2), causal=True, window=window,
                          q_offset=0)
        o = o.transpose(1, 2).reshape(b, s, cfg.q_dim)
        return o @ p["wo"]

    def _ssm_branch(self, p, h):
        cfg = self.cfg
        b, s, _ = h.shape
        nh, dk, dv = cfg.num_ssm_heads, cfg.ssm_state, _ssm_dv(cfg)
        q = (h @ p["s_wq"]).view(b, s, nh, dk).transpose(1, 2)
        k = (h @ p["s_wk"]).view(b, s, nh, dk).transpose(1, 2)
        v = (h @ p["s_wv"]).view(b, s, nh, dv).transpose(1, 2)
        # data-dependent log-decay (RWKV6-style): -softplus(xW + b)
        g = -F.softplus((h @ p["s_wg"]) + p["s_gbias"])
        g = g.view(b, s, nh, dk).transpose(1, 2)
        o, _ = gla_chunked(q, k, v, g)
        o = o.transpose(1, 2).reshape(b, s, nh * dv)
        return o @ p["s_wo"]

    def _decoder_block(self, p, x):
        cfg = self.cfg
        # both branches of a hybrid layer read the same ln1 norm
        h = rms_norm(x, p["ln1"], cfg.norm_eps)
        if cfg.family == "hybrid":
            a = self._attn_branch(p, h, window=cfg.sliding_window)
            x = x + (a + self._ssm_branch(p, h)) / 2.0
        elif cfg.has_ssm:  # pure SSM (rwkv)
            x = x + self._ssm_branch(p, h)
        else:
            x = x + self._attn_branch(p, h, window=0)
        f = mlp_block(rms_norm(x, p["ln2"], cfg.norm_eps), p["w1"], p["w2"],
                      p["w3"], cfg.mlp)
        return x + f

    # ------------------------------------------------------------ full pass
    def forward(self, batch: Dict[str, torch.Tensor]) -> Tuple[torch.Tensor, torch.Tensor]:
        """Logits of ``batch["tokens"]`` (B, S): returns (logits (B, S, Vp)
        in the model dtype, aux loss 0 (no MoE))."""
        cfg = self.cfg
        x = self.embed[batch["tokens"].long()]
        for i in range(cfg.num_layers):
            x = self._decoder_block({n: t[i] for n, t in self.layers.items()}, x)
        x = rms_norm(x, self.final_norm, cfg.norm_eps)
        aux = torch.zeros((), dtype=torch.float32, device=x.device)
        return x @ self.head, aux
