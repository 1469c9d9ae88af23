"""Config-driven decoder of the port: the reference's ``models/model.py``
for the families ``dense``, ``moe``, ``ssm`` and ``hybrid`` — the forward,
and the serving half: ``cache_spec`` / ``init_cache``, ``prefill`` and
``decode_step``.

Layer parameters are stacked on a leading L axis, as the reference stacks
them for its layer scan (``scan_layers=True``), so its parameter tree maps
one to one onto this module's state (``convert.model_params_from_arrays``);
the passes walk the layers in a Python loop.  Attention goes through the
flash wrapper, the SSM branch through the gla_chunk wrapper: the
hand-written kernels on the card, their plain versions on the CPU.  A decode
step attends one token against the cache (``layers.decode_attention``),
advances the SSM state (``linear_attn.gla_decode_step``) and routes MoE
tokens densely (``moe.moe_ffn_dense``): torch ops, as the reference's are
XLA with no Pallas original.  The decode cache is written in place, so its
tensors keep their storage from step to step.  The reference's ``remat``,
``scan`` and ``shard_hints`` are JAX/TPU machinery with no counterpart on
one card without a backward pass.
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from repro_torch.device import resolve_device
from repro_torch.models.config import ModelConfig
from repro_torch.models.layers import (decode_attention, mea_attention,
                                       mlp_block, rms_norm, rope)
from repro_torch.models.linear_attn import gla_chunked, gla_decode_step
from repro_torch.models.moe import moe_ffn, moe_ffn_dense

VOCAB_PAD = 128
FAMILIES = ("dense", "moe", "ssm", "hybrid")


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
    if cfg.is_moe:
        e = cfg.num_experts
        shapes.update(router=(d, e), e_w1=(e, d, f), e_w3=(e, d, f),
                      e_w2=(e, f, d))
    else:
        shapes.update(w1=(d, f), w3=(d, f), w2=(f, d))
    return shapes


def cache_spec(cfg: ModelConfig, batch: int, cache_len: int) -> Dict[str, Tuple[Tuple[int, ...], torch.dtype]]:
    """The decode cache's layout, name -> (shape, dtype): the reference's
    ``Model.cache_spec`` for the ported families.  ``pos`` (B,) int32 is each
    sequence's position; ``k``, ``v`` (L, B, Hkv, S, hd) in the model dtype,
    S = min(cache_len, window) for a sliding window (a ring) and cache_len
    without one; ``ssm`` (L, B, H, dk, dv) f32."""
    L = cfg.num_layers
    spec = {"pos": ((batch,), torch.int32)}
    if cfg.has_attention:
        window = cfg.sliding_window
        s = min(cache_len, window) if window else cache_len
        kv = ((L, batch, cfg.num_kv_heads, s, cfg.head_dim), _dt(cfg))
        spec["k"] = spec["v"] = kv
    if cfg.has_ssm:
        spec["ssm"] = ((L, batch, cfg.num_ssm_heads, cfg.ssm_state, _ssm_dv(cfg)),
                       torch.float32)
    return spec


class Model(nn.Module):
    """Inference-only decoder on ``device`` (the card by default; raises
    without one unless ``device="cpu"``), parameters in ``cfg.dtype``.
    Allocated empty: call :meth:`init` or load a state dict."""

    def __init__(self, cfg: ModelConfig, device="cuda"):
        super().__init__()
        cfg.validate()
        if cfg.family not in FAMILIES:
            what = {"encdec": "the encoder-decoder family",
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
    def _layer(self, i: int) -> Dict[str, torch.Tensor]:
        return {n: t[i] for n, t in self.layers.items()}

    def _attn_branch(self, p, h, *, window: int):
        """(output, (k after RoPE, v), each (B, Hkv, S, hd))."""
        cfg = self.cfg
        b, s, _ = h.shape
        q = (h @ p["wq"]).view(b, s, cfg.num_heads, cfg.head_dim)
        k = (h @ p["wk"]).view(b, s, cfg.num_kv_heads, cfg.head_dim)
        v = (h @ p["wv"]).view(b, s, cfg.num_kv_heads, cfg.head_dim)
        pos = torch.arange(s, device=h.device)
        q = rope(q.transpose(1, 2), pos, cfg.rope_theta)
        k = rope(k.transpose(1, 2), pos, cfg.rope_theta)
        v = v.transpose(1, 2)
        o = mea_attention(q, k, v, causal=True, window=window, q_offset=0)
        o = o.transpose(1, 2).reshape(b, s, cfg.q_dim)
        return o @ p["wo"], (k, v)

    def _ssm_branch(self, p, h):
        """(output, final state (B, H, dk, dv) f32)."""
        cfg = self.cfg
        b, s, _ = h.shape
        nh, dk, dv = cfg.num_ssm_heads, cfg.ssm_state, _ssm_dv(cfg)
        q = (h @ p["s_wq"]).view(b, s, nh, dk).transpose(1, 2)
        k = (h @ p["s_wk"]).view(b, s, nh, dk).transpose(1, 2)
        v = (h @ p["s_wv"]).view(b, s, nh, dv).transpose(1, 2)
        # data-dependent log-decay (RWKV6-style): -softplus(xW + b)
        g = -F.softplus((h @ p["s_wg"]) + p["s_gbias"])
        g = g.view(b, s, nh, dk).transpose(1, 2)
        o, state = gla_chunked(q, k, v, g)
        o = o.transpose(1, 2).reshape(b, s, nh * dv)
        return o @ p["s_wo"], state

    def _ffn_branch(self, p, x) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
        """(output, MoE aux loss or None): the reference's ``_ffn_branch``,
        with ``moe_dense_train`` and ``moe_chunk`` token chunks (the aux
        loss averaged over chunks)."""
        cfg = self.cfg
        h = rms_norm(x, p["ln2"], cfg.norm_eps)
        if not cfg.is_moe:
            return mlp_block(h, p["w1"], p["w2"], p["w3"], cfg.mlp), None
        b, s, d = h.shape
        flat = h.reshape(b * s, d)
        experts = (p["router"], p["e_w1"], p["e_w3"], p["e_w2"])
        if cfg.moe_dense_train:
            y = moe_ffn_dense(flat, *experts, top_k=cfg.top_k, mlp_kind=cfg.mlp)
            return y.view(b, s, d), None
        t, chunk = b * s, cfg.moe_chunk
        if not (chunk and t > chunk and t % chunk == 0):
            chunk = t
        outs = [moe_ffn(c, *experts, top_k=cfg.top_k,
                        capacity_factor=cfg.capacity_factor, mlp_kind=cfg.mlp)
                for c in flat.split(chunk)]
        y = torch.cat([o for o, _ in outs]).view(b, s, d)
        return y, torch.stack([a for _, a in outs]).mean()

    def _decoder_block(self, p, x):
        """(x out, (k, v) or None, final SSM state or None, aux or None)."""
        cfg = self.cfg
        kv = state = None
        # both branches of a hybrid layer read the same ln1 norm
        h = rms_norm(x, p["ln1"], cfg.norm_eps)
        if cfg.family == "hybrid":
            a, kv = self._attn_branch(p, h, window=cfg.sliding_window)
            sso, state = self._ssm_branch(p, h)
            x = x + (a + sso) / 2.0
        elif cfg.has_ssm:  # pure SSM (rwkv)
            sso, state = self._ssm_branch(p, h)
            x = x + sso
        else:
            a, kv = self._attn_branch(p, h, window=0)
            x = x + a
        f, aux = self._ffn_branch(p, x)
        return x + f, kv, state, aux

    # ------------------------------------------------------------ full pass
    def forward(self, batch: Dict[str, torch.Tensor]) -> Tuple[torch.Tensor, torch.Tensor]:
        """Logits of ``batch["tokens"]`` (B, S): returns (logits (B, S, Vp)
        in the model dtype, the MoE aux loss summed over layers, f32; 0
        without experts)."""
        cfg = self.cfg
        x = self.embed[batch["tokens"].long()]
        aux_total = torch.zeros((), dtype=torch.float32, device=x.device)
        for i in range(cfg.num_layers):
            x, _, _, aux = self._decoder_block(self._layer(i), x)
            if aux is not None:
                aux_total = aux_total + aux
        x = rms_norm(x, self.final_norm, cfg.norm_eps)
        return x @ self.head, aux_total

    # --------------------------------------------------------------- serving
    def cache_spec(self, batch: int, cache_len: int):
        return cache_spec(self.cfg, batch, cache_len)

    def init_cache(self, batch: int, cache_len: int) -> Dict[str, torch.Tensor]:
        """A zeroed decode cache on the model's device (see :func:`cache_spec`)."""
        dev = self.embed.device
        return {name: torch.zeros(shape, dtype=dt, device=dev)
                for name, (shape, dt) in self.cache_spec(batch, cache_len).items()}

    @torch.no_grad()
    def prefill(self, batch: Dict[str, torch.Tensor],
                cache_len: Optional[int] = None) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
        """The forward over the prompt ``batch["tokens"]`` (B, S), building the
        decode cache for ``cache_len`` positions (default S).  Returns
        (last-token logits (B, Vp), cache) with ``pos`` = S.  A ring shorter
        than the prompt keeps the last keys, rolled so that position p lives
        in slot p % ring."""
        cfg = self.cfg
        tokens = batch["tokens"]
        b, s = tokens.shape
        cache = self.init_cache(b, cache_len or max(s, 1))
        cache["pos"].fill_(s)
        x = self.embed[tokens.long()]
        for i in range(cfg.num_layers):
            x, kv, state, _ = self._decoder_block(self._layer(i), x)
            if kv is not None:
                store = cache["k"].shape[3]
                for name, t in zip(("k", "v"), kv):
                    if s <= store:
                        cache[name][i, :, :, :s] = t
                    else:
                        cache[name][i] = torch.roll(t[:, :, -store:], s % store, dims=2)
            if state is not None:
                cache["ssm"][i] = state
        x = rms_norm(x[:, -1, :], self.final_norm, cfg.norm_eps)
        return x @ self.head, cache

    @torch.no_grad()
    def decode_step(self, cache: Dict[str, torch.Tensor],
                    token: torch.Tensor) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
        """One decoding step of ``token`` (B,) at each sequence's ``pos``:
        writes its keys, values and SSM state into ``cache`` in place and
        advances ``pos``.  Returns (logits (B, Vp), cache).

        A windowed model's cache is a ring: the slot is pos % S and every
        slot is seen once the ring is full.  Without a window the slot is pos,
        clamped to S - 1 as the reference's ``dynamic_update_slice`` clamps
        it, so past the end the last slot is overwritten and every slot is
        seen."""
        cfg = self.cfg
        pos = cache["pos"]
        x = self.embed[token.long()]                           # (B, D)
        b = x.shape[0]
        if cfg.has_attention:
            store = cache["k"].shape[3]
            rows = torch.arange(b, device=x.device)
            pos64 = pos.long()
            if cfg.sliding_window:
                slot, seen = pos64 % store, pos64.clamp(max=store - 1)
            else:
                slot, seen = pos64.clamp(max=store - 1), pos64
            posv = pos.view(b, 1, 1)                           # broadcast over heads
        for i in range(cfg.num_layers):
            p = self._layer(i)
            hn = rms_norm(x, p["ln1"], cfg.norm_eps)
            attn_out = ssm_out = None
            if cfg.has_attention:
                q = (hn @ p["wq"]).view(b, cfg.num_heads, cfg.head_dim)
                k = (hn @ p["wk"]).view(b, cfg.num_kv_heads, cfg.head_dim)
                v = (hn @ p["wv"]).view(b, cfg.num_kv_heads, cfg.head_dim)
                q = rope(q[:, :, None, :], posv, cfg.rope_theta)[:, :, 0, :]
                k = rope(k[:, :, None, :], posv, cfg.rope_theta)[:, :, 0, :]
                kc, vc = cache["k"][i], cache["v"][i]
                kc[rows, :, slot] = k
                vc[rows, :, slot] = v
                o = decode_attention(q, kc, vc, pos=seen, window=0)
                attn_out = o.reshape(b, cfg.q_dim) @ p["wo"]
            if cfg.has_ssm:
                nh, dk, dv = cfg.num_ssm_heads, cfg.ssm_state, _ssm_dv(cfg)
                sq = (hn @ p["s_wq"]).view(b, nh, dk)
                sk = (hn @ p["s_wk"]).view(b, nh, dk)
                sv = (hn @ p["s_wv"]).view(b, nh, dv)
                sg = -F.softplus((hn @ p["s_wg"]) + p["s_gbias"]).view(b, nh, dk)
                so, state = gla_decode_step(sq, sk, sv, sg, cache["ssm"][i])
                cache["ssm"][i] = state
                ssm_out = so.reshape(b, nh * dv) @ p["s_wo"]
            if cfg.family == "hybrid":
                x = x + (attn_out + ssm_out) / 2.0
            elif cfg.has_ssm:
                x = x + ssm_out
            else:
                x = x + attn_out
            hf = rms_norm(x, p["ln2"], cfg.norm_eps)
            if cfg.is_moe:
                # dropless dense combine: exact routing, no sort or scatter
                y = moe_ffn_dense(hf, p["router"], p["e_w1"], p["e_w3"],
                                  p["e_w2"], top_k=cfg.top_k, mlp_kind=cfg.mlp)
            else:
                y = mlp_block(hf, p["w1"], p["w2"], p["w3"], cfg.mlp)
            x = x + y
        pos.add_(1)
        x = rms_norm(x, self.final_norm, cfg.norm_eps)
        return x @ self.head, cache
