"""Config-driven model of the port: the reference's ``models/model.py`` for
all six families (``dense``, ``moe``, ``ssm``, ``hybrid``, the
encoder-decoder ``encdec`` and the ``vlm``) — the forward (differentiable:
``train/step.py`` trains through it), and the serving half: ``cache_spec`` /
``init_cache``, ``prefill`` and ``decode_step``.

Layer parameters are stacked on a leading L axis, as the reference stacks
them for its layer scan (``scan_layers=True``), so its parameter tree maps
one to one onto this module's state (``convert.model_params_from_arrays``);
the passes walk the layers in a Python loop over one ``unbind(0)`` view of
each stack (one view per layer, whose backward writes its slice of the
stack's gradient; indexing ``t[i]`` would write a zero tensor of the whole
stack for every layer).  Attention goes through the flash wrapper, the SSM
branch through the gla_chunk wrapper: the hand-written kernels on the card,
forward and backward, their plain versions on the CPU.  With ``cfg.remat``
each block of a differentiated forward (decoder and encoder) runs under
``torch.utils.checkpoint`` (the reference's ``jax.checkpoint`` with
``nothing_saveable``): only the block's input is kept, and the backward runs
the block's forward again.  With ``cfg.remat_groups`` G > 1 dividing the
depth L, each group of L / G decoder blocks runs under one more checkpoint
(the reference's two-level "sqrt" remat, applied with or without
``cfg.remat``): the backward keeps G group inputs and re-runs one group at
a time.  The stub frontends are the reference's: an encoder-decoder
(whisper) encodes ``batch["frames"]`` (B, enc_seq, D) with rope and
non-causal self-attention, and each decoder layer attends to the encoded
sequence through its own ``xwk`` / ``xwv`` projections (non-causal,
through the flash wrapper; in decoding against the ``cross_k`` / ``cross_v``
cache that ``prefill`` fills); a VLM (llava) prepends
``batch["patch_embeds"]`` (B, P, D), cast to the model dtype, to the token
embeddings, so its logits are P + S long.  A decode step attends one token
against the cache (``layers.decode_attention``), advances the SSM state
(``linear_attn.gla_decode_step``) and routes MoE tokens densely
(``moe.moe_ffn_dense``): torch ops, as the reference's are XLA with no
Pallas original.  ``prefill`` and ``decode_step`` run under ``no_grad``; the
decode cache is written in place, so its tensors keep their storage from
step to step.  The reference's ``scan`` is JAX machinery with no
counterpart: the layers run in a Python loop.

The model runs on a device mesh too: with its parameters DTensors
(``train.sharding.shard_model``), every op is DTensor's, the flash and GLA
kernels run on each rank's shard (their sharding rules), the MoE FFN runs
expert-parallel (each rank its own experts and capacity rows: ``moe.py``),
and the decode cache is made and written as DTensors
(``train.sharding.cache_pspecs``).  ``shard_hints`` is the reference's
counterpart: with it set (``dp``, ``tp``, ``dp_ok``, ``sp``), the hidden
states at block boundaries and the logits are redistributed to the
reference's placements (``_c``: ``hidden3`` (dp, sp, None), ``hidden2``
(dp, None), ``logits3`` (dp, sp, tp or None), ``logits2`` (dp, tp)), and each
norm's output, the projections' input, to (dp, None, ...), whole over the
model axis (what GSPMD works out for the reference; DTensor would compute
the projections whole on every model rank).  With plain parameters and
``shard_hints`` None every op is what it was.
"""

from __future__ import annotations

import contextlib
from typing import Any, Dict, List, Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn
from torch.distributed import tensor as dtensor
from torch._subclasses.fake_tensor import maybe_get_fake_mode
from torch.distributed.tensor import DTensor, Partial, Replicate, Shard
from torch.utils.checkpoint import checkpoint

from repro_torch.device import resolve_device
from repro_torch.models.config import ModelConfig
from repro_torch.models.layers import (decode_attention, heads, like, mea_attention, roll,
                                       mlp_block, rms_norm, rope)
from repro_torch.models.linear_attn import gla_chunked, gla_decode_step
from repro_torch.models.moe import moe_ffn, moe_ffn_dense
from repro_torch.train import sharding

VOCAB_PAD = 128
FAMILIES = ("dense", "moe", "ssm", "hybrid", "encdec", "vlm")


def _dt(cfg: ModelConfig) -> torch.dtype:
    return torch.bfloat16 if cfg.dtype == "bfloat16" else torch.float32


def padded_vocab(cfg: ModelConfig) -> int:
    return ((cfg.vocab_size + VOCAB_PAD - 1) // VOCAB_PAD) * VOCAB_PAD


def _ssm_dv(cfg: ModelConfig) -> int:
    if cfg.family == "ssm":
        return cfg.d_model // cfg.num_ssm_heads
    return cfg.head_dim


def layer_shapes(cfg: ModelConfig, cross: Optional[bool] = None) -> Dict[str, Tuple[int, ...]]:
    """One layer's parameter shapes (the reference's ``Model._layer_shapes``):
    with ``cross`` the cross-attention's ``ln_x``, ``xwq``, ``xwk``, ``xwv``
    and ``xwo`` too.  ``cross`` defaults to the decoder's (an
    encoder-decoder's decoder layers have them); the encoder's layers are
    ``cross=False``."""
    if cross is None:
        cross = cfg.family == "encdec"
    d, qd, kvd, f = cfg.d_model, cfg.q_dim, cfg.kv_dim, cfg.d_ff
    shapes: Dict[str, Tuple[int, ...]] = {"ln1": (d,), "ln2": (d,)}
    if cfg.has_attention:
        shapes.update(wq=(d, qd), wk=(d, kvd), wv=(d, kvd), wo=(qd, d))
    if cfg.has_ssm:
        nh, dk, dv = cfg.num_ssm_heads, cfg.ssm_state, _ssm_dv(cfg)
        shapes.update(s_wq=(d, nh * dk), s_wk=(d, nh * dk),
                      s_wv=(d, nh * dv), s_wg=(d, nh * dk),
                      s_gbias=(nh * dk,), s_wo=(nh * dv, d))
    if cross:
        shapes.update(ln_x=(d,), xwq=(d, qd), xwk=(d, kvd), xwv=(d, kvd), xwo=(qd, d))
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
    without one; ``ssm`` (L, B, H, dk, dv) f32; an encoder-decoder's
    ``cross_k``, ``cross_v`` (L, B, Hkv, enc_seq, hd) in the model dtype."""
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
    if cfg.family == "encdec":
        spec["cross_k"] = spec["cross_v"] = (
            (L, batch, cfg.num_kv_heads, cfg.enc_seq, cfg.head_dim), _dt(cfg))
    return spec


class Model(nn.Module):
    """Decoder on ``device`` (the card by default; raises without one unless
    ``device="cpu"``), parameters in ``cfg.dtype``.  Allocated empty: call
    :meth:`init` or load a state dict.  The parameters are created without
    ``requires_grad``; training switches them on with PyTorch's own
    ``model.requires_grad_(True)`` (``train.step.init_train_state``)."""

    def __init__(self, cfg: ModelConfig, device="cuda"):
        super().__init__()
        cfg.validate()
        if cfg.family not in FAMILIES:
            raise ValueError(f"{cfg.name}: unknown family {cfg.family!r}; the port runs "
                             f"{FAMILIES}")
        self.cfg = cfg
        # activation placements on a mesh (the reference's shard_hints): None,
        # or {"dp": data axes, "tp": model axis, "dp_ok": batch divisible by
        # dp, "sp": sequence-parallel residual stream}
        self.shard_hints: Optional[Dict[str, Any]] = None
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
        if cfg.family == "encdec":
            self.enc_layers = nn.ParameterDict(
                {name: empty(cfg.encoder_layers, *shp)
                 for name, shp in sorted(layer_shapes(cfg, cross=False).items())})
            self.enc_norm = empty(cfg.d_model)

    def _c(self, x, kind: str):
        """x redistributed to the placements ``shard_hints`` give ``kind``
        (the reference's ``_c``); x itself without hints or off a mesh."""
        h = self.shard_hints
        if not h or not isinstance(x, DTensor):
            return x
        dp = h.get("dp") if h.get("dp_ok", True) else None
        tp = h.get("tp")
        # sequence-parallel TP: the residual stream between blocks sharded
        # over the model axis along the sequence
        sp = tp if h.get("sp") else None
        spec = {"hidden3": (dp, sp, None),              # (B, S, D)
                "hidden2": (dp, None),                  # (B, D)
                "logits3": (dp, sp, tp if not sp else None),  # (B, S, V)
                "logits2": (dp, tp),                    # (B, V)
                # a norm's output, the input of the projections: whole over
                # the model axis, so each rank computes its slice of their
                # outputs (DTensor's cost model weighs bytes moved, not
                # FLOPs, and would keep a partial sum here and compute every
                # projection whole on every model rank)
                "norm3": (dp, None, None),
                "norm2": (dp, None)}[kind]
        mesh = x.device_mesh
        return x.redistribute(mesh, sharding.placements(spec, mesh))

    def _lookup(self, tokens):
        """The tokens' embedding rows.  On a mesh each rank gathers from its
        own columns of the table for its own tokens (no DTensor op: a
        gather's gradient, an indexed accumulate, has no usable sharding
        rule), and declares the table's gradient a partial sum over the
        mesh dims that split the tokens."""
        if not isinstance(self.embed, DTensor):
            return self.embed[tokens.long()]
        mesh = self.embed.device_mesh
        rows, cols = tokens.placements, self.embed.placements
        if any(r.is_shard() and c.is_shard() for r, c in zip(rows, cols)):
            raise ValueError(f"tokens {rows} and embedding {cols} split one mesh dim")
        out = [Shard(0) if r.is_shard() else Shard(tokens.ndim) if c.is_shard() else Replicate()
               for r, c in zip(rows, cols)]
        grad = [Partial() if r.is_shard() else c for r, c in zip(rows, cols)]
        local = self.embed.to_local(grad_placements=grad)[tokens.to_local().long()]
        return DTensor.from_local(local, mesh, out, run_check=False)

    def _norm(self, x, weight, kind: str):
        """``rms_norm`` of x, placed as ``kind`` on a mesh with hints."""
        return self._c(rms_norm(x, weight, self.cfg.norm_eps), kind)

    @contextlib.contextmanager
    def _mesh_inference(self):
        """For the no-grad passes on a mesh: plain tensors (positions, slots,
        masks; the same on every rank) read as replicated DTensors.  The
        flag is saved and restored, so passes nest."""
        if not isinstance(self.embed, DTensor):
            yield
            return
        dispatcher = DTensor._op_dispatcher
        before = dispatcher._allow_implicit_replication
        dispatcher._allow_implicit_replication = True
        try:
            yield
        finally:
            dispatcher._allow_implicit_replication = before

    def _stacks(self):
        """The stacked layer parameter dicts: the decoder's, then the
        encoder's where there is one."""
        return [self.layers] + ([self.enc_layers] if self.cfg.family == "encdec" else [])

    @torch.no_grad()
    def init(self, generator: torch.Generator) -> "Model":
        """Random weights from ``generator`` with the reference's
        distributions (``model.py`` ``_init_stack`` / ``init``): norms 0,
        ``s_gbias`` -1, matrices N(0, 1) * fan_in^-0.5, vectors N(0, 1) *
        0.02, the embedding N(0, 1) * 0.02, the head N(0, 1) * d^-0.5.
        Drawn in f32 on the generator's device, then cast and copied; an
        encoder's stack after the head, its norm 0."""
        def normal(p: torch.Tensor, scale: float) -> None:
            x = torch.randn(p.shape, generator=generator, dtype=torch.float32,
                            device=generator.device)
            p.copy_(x.mul_(scale))

        def stack(layers: nn.ParameterDict) -> None:
            for name, p in layers.items():
                shp = p.shape[1:]
                if name.startswith("ln"):
                    p.zero_()
                elif name == "s_gbias":
                    p.fill_(-1.0)
                else:
                    fan_in = shp[-2] if len(shp) >= 2 else shp[-1]
                    normal(p, 0.02 if len(shp) < 2 else fan_in ** -0.5)

        normal(self.embed, 0.02)
        stack(self.layers)
        self.final_norm.zero_()
        normal(self.head, self.cfg.d_model ** -0.5)
        if self.cfg.family == "encdec":
            stack(self.enc_layers)
            self.enc_norm.zero_()
        return self

    # ------------------------------------------------------------- the block
    def _per_layer(self, stacks: Optional[nn.ParameterDict] = None) -> List[Dict[str, torch.Tensor]]:
        """Each layer's parameters (the decoder's, or ``stacks``'): views of
        the stacks, one ``unbind`` per stack and pass."""
        stacks = self.layers if stacks is None else stacks
        views = {n: t.unbind(0) for n, t in stacks.items()}
        depth = next(iter(stacks.values())).shape[0]
        return [{n: v[i] for n, v in views.items()} for i in range(depth)]

    def _attention(self, p, h):
        """q (B, H, S, hd), k and v (B, Hkv, S, hd) of ``h``, before RoPE."""
        cfg = self.cfg
        b, s, _ = h.shape
        q = heads(h @ p["wq"], b, s, cfg.num_heads, cfg.head_dim)
        k = heads(h @ p["wk"], b, s, cfg.num_kv_heads, cfg.head_dim)
        v = heads(h @ p["wv"], b, s, cfg.num_kv_heads, cfg.head_dim)
        return q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2)

    def _attn_branch(self, p, h, *, window: int):
        """(output, (k after RoPE, v), each (B, Hkv, S, hd)): causal
        self-attention, within ``window`` when it is > 0."""
        cfg = self.cfg
        b, s, _ = h.shape
        q, k, v = self._attention(p, h)
        pos = torch.arange(s, device=h.device)
        q = rope(q, pos, cfg.rope_theta)
        k = rope(k, pos, cfg.rope_theta)
        o = mea_attention(q, k, v, causal=True, window=window, q_offset=0)
        o = o.transpose(1, 2).reshape(b, s, cfg.q_dim)
        return o @ p["wo"], (k, v)

    def _cross_kv(self, p, enc):
        """A decoder layer's keys and values of the encoded sequence enc (B,
        enc_seq, D): (B, Hkv, enc_seq, hd) each, no RoPE."""
        cfg = self.cfg
        b, se, _ = enc.shape
        ek = heads(enc @ p["xwk"], b, se, cfg.num_kv_heads, cfg.head_dim).transpose(1, 2)
        ev = heads(enc @ p["xwv"], b, se, cfg.num_kv_heads, cfg.head_dim).transpose(1, 2)
        return ek, ev

    def _cross_branch(self, p, x, enc_kv):
        """Non-causal attention of x's queries (``ln_x``, ``xwq``, no RoPE)
        over the encoded sequence's keys and values: Sq != Skv."""
        cfg = self.cfg
        b, s, _ = x.shape
        h = self._norm(x, p["ln_x"], "norm3")
        q = heads(h @ p["xwq"], b, s, cfg.num_heads, cfg.head_dim).transpose(1, 2)
        o = mea_attention(q, *enc_kv, causal=False)
        return o.transpose(1, 2).reshape(b, s, cfg.q_dim) @ p["xwo"]

    def _encoder_block(self, p, x):
        """One encoder layer: RoPE and non-causal self-attention over the
        frames, then the MLP (the reference's ``_encoder_block``)."""
        cfg = self.cfg
        b, s, _ = x.shape
        q, k, v = self._attention(p, self._norm(x, p["ln1"], "norm3"))
        pos = torch.arange(s, device=x.device)
        q, k = rope(q, pos, cfg.rope_theta), rope(k, pos, cfg.rope_theta)
        o = mea_attention(q, k, v, causal=False)
        x = x + o.transpose(1, 2).reshape(b, s, cfg.q_dim) @ p["wo"]
        h = self._norm(x, p["ln2"], "norm3")
        return x + mlp_block(h, p["w1"], p["w2"], p["w3"], cfg.mlp)

    def _ssm_branch(self, p, h):
        """(output, final state (B, H, dk, dv) f32)."""
        cfg = self.cfg
        b, s, _ = h.shape
        nh, dk, dv = cfg.num_ssm_heads, cfg.ssm_state, _ssm_dv(cfg)
        q = heads(h @ p["s_wq"], b, s, nh, dk).transpose(1, 2)
        k = heads(h @ p["s_wk"], b, s, nh, dk).transpose(1, 2)
        v = heads(h @ p["s_wv"], b, s, nh, dv).transpose(1, 2)
        # data-dependent log-decay (RWKV6-style): -softplus(xW + b)
        g = -F.softplus((h @ p["s_wg"]) + p["s_gbias"])
        g = heads(g, b, s, nh, dk).transpose(1, 2)
        o, state = gla_chunked(q, k, v, g)
        o = o.transpose(1, 2).reshape(b, s, nh * dv)
        return o @ p["s_wo"], state

    def _ffn_branch(self, p, x) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
        """(output, MoE aux loss or None): the reference's ``_ffn_branch``,
        with ``moe_dense_train`` and ``moe_chunk`` token chunks (the aux
        loss averaged over chunks)."""
        cfg = self.cfg
        h = self._norm(x, p["ln2"], "norm3")
        if not cfg.is_moe:
            return mlp_block(h, p["w1"], p["w2"], p["w3"], cfg.mlp), None
        b, s, d = h.shape
        flat = h.reshape(b * s, d)
        experts = (p["router"], p["e_w1"], p["e_w3"], p["e_w2"])
        if cfg.moe_dense_train:
            y = moe_ffn_dense(flat, *experts, top_k=cfg.top_k, mlp_kind=cfg.mlp)
            return y.view(b, s, d), None
        t, chunk = b * s, cfg.moe_chunk
        # one chunk is the tokens as placed: on a mesh a split or a cat of
        # the rows would gather them onto every rank
        chunks = flat.split(chunk) if chunk and t > chunk and t % chunk == 0 else [flat]
        outs = [moe_ffn(c, *experts, top_k=cfg.top_k,
                        capacity_factor=cfg.capacity_factor, mlp_kind=cfg.mlp)
                for c in chunks]
        y = torch.cat([o for o, _ in outs]) if len(outs) > 1 else outs[0][0]
        return y.view(b, s, d), torch.stack([a for _, a in outs]).mean()

    def _decoder_block(self, p, x, enc=None):
        """(x out, (k, v) or None, final SSM state or None, aux or None,
        (cross k, cross v) or None).  ``enc``: the encoded sequence of an
        encoder-decoder, whose keys and values the layer projects."""
        cfg = self.cfg
        kv = state = None
        # both branches of a hybrid layer read the same ln1 norm
        h = self._norm(x, p["ln1"], "norm3")
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
        enc_kv = None
        if enc is not None:
            enc_kv = self._cross_kv(p, enc)
            x = x + self._cross_branch(p, x, enc_kv)
        f, aux = self._ffn_branch(p, x)
        return x + f, kv, state, aux, enc_kv

    def _train_block(self, p, x, enc=None) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
        x, _, _, aux, _ = self._decoder_block(p, x, enc)
        return self._c(x, "hidden3"), aux

    def _blocks(self, ps, x, aux_total, enc, remat: bool):
        """x and the aux sum through the decoder layers ``ps`` in order, each
        under a checkpoint when ``remat``."""
        for p in ps:
            if remat:
                x, aux = checkpoint(self._train_block, p, x, enc, use_reentrant=False)
            else:
                x, aux = self._train_block(p, x, enc)
            if aux is not None:
                aux_total = aux_total + aux
        return x, aux_total

    def _embed_inputs(self, batch) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
        """(x, the encoded sequence or None): the token embeddings, after a
        VLM's patch embeddings; an encoder-decoder's frames through the
        encoder stack (per-block remat as the decoder's) and ``enc_norm``."""
        cfg = self.cfg
        if isinstance(self.embed, DTensor):
            batch = sharding.place_batch(batch, self.embed.device_mesh)
        x = self._lookup(batch["tokens"])
        if cfg.family == "vlm":
            x = torch.cat([batch["patch_embeds"].to(x.dtype), x], dim=1)
        if cfg.family != "encdec":
            return x, None
        enc = batch["frames"].to(x.dtype)
        remat = cfg.remat and torch.is_grad_enabled()
        for p in self._per_layer(self.enc_layers):
            enc = (checkpoint(self._encoder_block, p, enc, use_reentrant=False) if remat
                   else self._encoder_block(p, enc))
        return x, self._norm(enc, self.enc_norm, "norm3")

    # ------------------------------------------------------------ full pass
    def forward(self, batch: Dict[str, torch.Tensor]) -> Tuple[torch.Tensor, torch.Tensor]:
        """Logits of ``batch["tokens"]`` (B, S) (with ``frames`` (B,
        enc_seq, D) for an encoder-decoder, ``patch_embeds`` (B, P, D) for
        a VLM): returns (logits (B, S, Vp), (B, P + S, Vp) for a VLM, in the
        model dtype; the MoE aux loss summed over layers, f32, 0 without
        experts).  Differentiable.  When grad is enabled: each block under a
        checkpoint when ``cfg.remat`` is set, and each group of L / G
        decoder blocks under one more when ``cfg.remat_groups`` G > 1
        divides L."""
        cfg = self.cfg
        x, enc = self._embed_inputs(batch)
        aux_total = like(torch.zeros((), dtype=torch.float32, device=x.device), x)
        x = self._c(x, "hidden3")
        grad = torch.is_grad_enabled()
        remat = cfg.remat and grad
        layers = self._per_layer()
        G, L = cfg.remat_groups, cfg.num_layers
        if grad and G > 1 and L % G == 0:
            n = L // G
            for g0 in range(0, L, n):
                x, aux_total = checkpoint(self._blocks, layers[g0:g0 + n], x, aux_total,
                                          enc, remat, use_reentrant=False)
        else:
            x, aux_total = self._blocks(layers, x, aux_total, enc, remat)
        x = self._norm(x, self.final_norm, "norm3")
        return self._c(x @ self.head, "logits3"), aux_total

    # --------------------------------------------------------------- serving
    def cache_spec(self, batch: int, cache_len: int):
        return cache_spec(self.cfg, batch, cache_len)

    def init_cache(self, batch: int, cache_len: int) -> Dict[str, torch.Tensor]:
        """A zeroed decode cache on the model's device (see :func:`cache_spec`);
        on a mesh, DTensors placed by ``sharding.cache_pspecs``."""
        spec = self.cache_spec(batch, cache_len)
        if isinstance(self.embed, DTensor):
            mesh = self.embed.device_mesh
            specs = sharding.cache_pspecs({n: shape for n, (shape, _) in spec.items()}, mesh)
            # fake parameters (a dry run's trace) get a fake cache
            fake = maybe_get_fake_mode(self.embed.to_local())
            with fake if fake is not None else contextlib.nullcontext():
                return {n: dtensor.zeros(shape, dtype=dt, device_mesh=mesh,
                                         placements=sharding.placements(specs[n], mesh))
                        for n, (shape, dt) in spec.items()}
        dev = self.embed.device
        return {name: torch.zeros(shape, dtype=dt, device=dev)
                for name, (shape, dt) in spec.items()}

    @torch.no_grad()
    def prefill(self, batch: Dict[str, torch.Tensor],
                cache_len: Optional[int] = None) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
        """The forward over the prompt ``batch["tokens"]`` (B, S) (and the
        family's ``frames`` or ``patch_embeds``), building the decode cache
        for ``cache_len`` positions (default S).  Returns (last-token logits
        (B, Vp), cache) with ``pos`` = N, the positions the forward ran (S,
        or P + S for a VLM), and an encoder-decoder's ``cross_k`` /
        ``cross_v``.  A cache shorter than N keeps the last keys, rolled by
        S (the reference's roll) so that in a ring position p lives in slot
        p % ring."""
        with self._mesh_inference():
            return self._prefill(batch, cache_len)

    def _prefill(self, batch, cache_len):
        cfg = self.cfg
        tokens = batch["tokens"]
        b, s = tokens.shape
        cache = self.init_cache(b, cache_len or max(s, 1))
        x, enc = self._embed_inputs(batch)
        n = x.shape[1]
        cache["pos"].fill_(n)
        for i, p in enumerate(self._per_layer()):
            x, kv, state, _, enc_kv = self._decoder_block(p, x, enc)
            x = self._c(x, "hidden3")
            if kv is not None:
                store = cache["k"].shape[3]
                for name, t in zip(("k", "v"), kv):
                    if n <= store and isinstance(t, DTensor):
                        # a slice of a sequence-sharded cache takes no
                        # in-place write: write the whole layer, zero-padded
                        zero = torch.zeros((), dtype=t.dtype, device=t.device)
                        pad = like(zero, t).expand(*t.shape[:2], store - n, t.shape[3])
                        cache[name][i].copy_(torch.cat([t, pad], dim=2))
                    elif n <= store:
                        cache[name][i, :, :, :n] = t
                    else:
                        cache[name][i] = roll(t[:, :, -store:], s % store, 2)
            if state is not None:
                cache["ssm"][i] = state
            if enc_kv is not None:
                cache["cross_k"][i], cache["cross_v"][i] = enc_kv
        x = self._norm(x[:, -1, :], self.final_norm, "norm2")
        return self._c(x @ self.head, "logits2"), cache

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
        seen.  An encoder-decoder's token then attends to the whole
        encoded sequence in ``cross_k`` / ``cross_v``."""
        with self._mesh_inference():
            return self._decode_step(cache, token)

    def _decode_step(self, cache, token):
        cfg = self.cfg
        pos = cache["pos"]
        if isinstance(self.embed, DTensor):
            token = sharding.place_batch({"token": token}, self.embed.device_mesh)["token"]
        x = self._lookup(token)                                # (B, D)
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
        if cfg.family == "encdec":                             # every encoded frame
            enc_pos = torch.full((b,), cfg.enc_seq - 1, dtype=torch.int32, device=x.device)
        for i, p in enumerate(self._per_layer()):
            hn = self._norm(x, p["ln1"], "norm2")
            attn_out = ssm_out = None
            if cfg.has_attention:
                q = heads(hn @ p["wq"], b, cfg.num_heads, cfg.head_dim)
                k = heads(hn @ p["wk"], b, cfg.num_kv_heads, cfg.head_dim)
                v = heads(hn @ p["wv"], b, cfg.num_kv_heads, cfg.head_dim)
                q = rope(q[:, :, None, :], posv, cfg.rope_theta)[:, :, 0, :]
                k = rope(k[:, :, None, :], posv, cfg.rope_theta)[:, :, 0, :]
                kc, vc = cache["k"][i], cache["v"][i]
                if isinstance(kc, DTensor):
                    # a sharded cache takes no indexed write: select each
                    # row's slot over the whole layer
                    hit = (torch.arange(store, device=x.device)[None, :] == slot[:, None])
                    hit = hit[:, None, :, None]
                    kc.copy_(torch.where(hit, k[:, :, None, :], kc))
                    vc.copy_(torch.where(hit, v[:, :, None, :], vc))
                else:
                    kc[rows, :, slot] = k
                    vc[rows, :, slot] = v
                o = decode_attention(q, kc, vc, pos=seen, window=0)
                # on a mesh each branch's output is placed as the residual
                # stream before it is added: for a batch the data axes do
                # not divide, torch 2.11's DTensor otherwise picks a
                # redistribution it cannot run (Shard to Partial)
                attn_out = self._c(o.reshape(b, cfg.q_dim) @ p["wo"], "hidden2")
            if cfg.has_ssm:
                nh, dk, dv = cfg.num_ssm_heads, cfg.ssm_state, _ssm_dv(cfg)
                sq = heads(hn @ p["s_wq"], b, nh, dk)
                sk = heads(hn @ p["s_wk"], b, nh, dk)
                sv = heads(hn @ p["s_wv"], b, nh, dv)
                sg = heads(-F.softplus((hn @ p["s_wg"]) + p["s_gbias"]), b, nh, dk)
                so, state = gla_decode_step(sq, sk, sv, sg, cache["ssm"][i])
                cache["ssm"][i] = state
                ssm_out = self._c(so.reshape(b, nh * dv) @ p["s_wo"], "hidden2")
            if cfg.family == "hybrid":
                x = x + (attn_out + ssm_out) / 2.0
            elif cfg.has_ssm:
                x = x + ssm_out
            else:
                x = x + attn_out
            if cfg.family == "encdec":
                hx = self._norm(x, p["ln_x"], "norm2")
                q = heads(hx @ p["xwq"], b, cfg.num_heads, cfg.head_dim)
                xk, xv = cache["cross_k"][i], cache["cross_v"][i]
                o = decode_attention(q, xk, xv, pos=enc_pos, window=0)
                x = x + self._c(o.reshape(b, cfg.q_dim) @ p["xwo"], "hidden2")
            hf = self._norm(x, p["ln2"], "norm2")
            if cfg.is_moe:
                # dropless dense combine: exact routing, no sort or scatter
                y = moe_ffn_dense(hf, p["router"], p["e_w1"], p["e_w3"],
                                  p["e_w2"], top_k=cfg.top_k, mlp_kind=cfg.mlp)
            else:
                y = mlp_block(hf, p["w1"], p["w2"], p["w3"], cfg.mlp)
            x = self._c(x + self._c(y, "hidden2"), "hidden2")
        pos.add_(1)
        x = self._norm(x, self.final_norm, "norm2")
        return self._c(x @ self.head, "logits2"), cache


def build_model(cfg: ModelConfig, device="cuda") -> Model:
    """The reference's ``build_model``: a :class:`Model` of the validated
    ``cfg`` on ``device``, allocated empty (call :meth:`Model.init`)."""
    return Model(cfg.validate(), device=device)
