"""The port's decode path held to the reference's, on the CPU.

``layers.decode_attention`` and ``linear_attn.gla_decode_step`` against the
reference's functions, then ``Model.prefill`` and ``Model.decode_step`` of
reduced configs (f32, 2 layers, width 64) with the reference's own weights
(``model_params_from_arrays``) against its ``prefill`` and jitted
``decode_step``: the prefill logits, every cache tensor, and the logits of
every decode step.  Inputs come from numpy seeds.

Tolerances: both sides run the same f32 arithmetic in different orders
(chunked scans of 32 against the port's chunks of 64 for GLA, online against
dense softmax in the prefill), so the logits are held at 5e-5 (the largest
gap measured is 3.6e-6, on logits of magnitude ~4) and the f32 attention
and GLA steps at 1e-5; bf16 attention at 1e-2 (a bf16 step is 2^-7 of |o|).
bf16 logits differ where either side rounded an intermediate the other way:
every gap is held within 2e-2 of its row's largest |logit| (about three
bf16 steps at the top of the row; measured up to 1.3 %).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import layers as ref_layers
from repro.models import linear_attn as ref_linear_attn
from repro_torch.convert import cache_from_arrays
from repro_torch.kernels.flash_attn import flash_attention
from repro_torch.kernels.gla_chunk import gla_chunked
from repro_torch.models import layers, linear_attn
from repro_torch.models.model import cache_spec

from torch_parity import both_models

LOGIT_TOL = 5e-5
PORTED = ("gemma-7b", "granite-20b", "granite-moe-1b-a400m", "hymba-1.5b",
          "internlm2-1.8b", "mistral-large-123b", "olmoe-1b-7b", "rwkv6-7b")


def _np(t):
    return t.detach().float().numpy()


def _ref_cache(cache):
    return jax.tree.map(np.asarray, cache)


# ---------------------------------------------------------------------------
# decode_attention, gla_decode_step
# ---------------------------------------------------------------------------

# (B, Hq, Hkv, S, d, pos, window, dtype)
ATTN_CASES = {
    "gqa_8_2": (3, 8, 2, 24, 16, [0, 10, 23], 0, np.float32),
    "mha": (2, 4, 4, 16, 32, [7, 15], 0, np.float32),
    "window": (3, 8, 2, 24, 16, [3, 12, 23], 6, np.float32),
    "pos_past_end": (3, 8, 2, 24, 16, [5, 30, 400], 0, np.float32),
    "window_past_end": (2, 4, 1, 12, 16, [20, 11], 5, np.float32),
    "bf16": (2, 10, 2, 40, 64, [0, 39], 0, jnp.bfloat16),
}


@pytest.mark.parametrize("case", sorted(ATTN_CASES))
def test_decode_attention_matches_the_reference(case):
    b, hq, hkv, s, d, pos, window, dtype = ATTN_CASES[case]
    rng = np.random.default_rng(hq + s)
    q = rng.normal(0, 1, (b, hq, d)).astype(np.float32)
    k, v = (rng.normal(0, 1, (b, hkv, s, d)).astype(np.float32) for _ in range(2))
    pos = np.asarray(pos, np.int32)
    want = ref_layers.decode_attention(
        *(jnp.asarray(x).astype(dtype) for x in (q, k, v)),
        pos=jnp.asarray(pos), window=window)
    tdt = torch.bfloat16 if dtype == jnp.bfloat16 else torch.float32
    got = layers.decode_attention(*(torch.from_numpy(x).to(tdt) for x in (q, k, v)),
                                  pos=torch.from_numpy(pos), window=window)
    assert got.shape == (b, hq, d) and got.dtype == tdt
    tol = 1e-2 if dtype == jnp.bfloat16 else 1e-5
    np.testing.assert_allclose(_np(got), np.asarray(want, np.float32), rtol=tol, atol=tol)


def test_decode_attention_masks_by_position():
    """Slots past pos (and before pos - window) do not count: filling them
    with garbage changes nothing."""
    rng = np.random.default_rng(4)
    q = torch.from_numpy(rng.normal(0, 1, (2, 4, 16)).astype(np.float32))
    k, v = (torch.from_numpy(rng.normal(0, 1, (2, 2, 20, 16)).astype(np.float32))
            for _ in range(2))
    pos = torch.tensor([6, 12], dtype=torch.int32)
    a = layers.decode_attention(q, k, v, pos=pos, window=4)
    k2, v2 = k.clone(), v.clone()
    for i, p in enumerate(pos.tolist()):
        for t in (slice(p + 1, None), slice(0, p - 4 + 1)):
            k2[i, :, t] = 1e3
            v2[i, :, t] = -1e3
    assert torch.equal(a, layers.decode_attention(q, k2, v2, pos=pos, window=4))


@pytest.mark.parametrize("dk,dv", [(8, 16), (16, 64)])
def test_gla_decode_step_matches_the_reference(dk, dv):
    """o and the new state after 6 steps; some decays below the -8 clamp."""
    rng = np.random.default_rng(dk + dv)
    b, h = 2, 3
    state_r = jnp.zeros((b, h, dk, dv), jnp.float32)
    state = torch.zeros(b, h, dk, dv)
    for t in range(6):
        q, k = (rng.normal(0, 1, (b, h, dk)).astype(np.float32) for _ in range(2))
        v = rng.normal(0, 1, (b, h, dv)).astype(np.float32)
        g = -rng.uniform(0.01, 1.0, (b, h, dk)).astype(np.float32)
        g[:, 0, :2] = -12.0                                 # clamped to -8
        o_r, state_r = ref_linear_attn.gla_decode_step(
            *(jnp.asarray(x) for x in (q, k, v, g)), state_r)
        o, state = linear_attn.gla_decode_step(
            *(torch.from_numpy(x) for x in (q, k, v, g)), state)
        assert state.dtype == torch.float32 and o.shape == (b, h, dv)
        np.testing.assert_allclose(o.numpy(), np.asarray(o_r), rtol=1e-5, atol=1e-5)
        np.testing.assert_allclose(state.numpy(), np.asarray(state_r), rtol=1e-5, atol=1e-5)


# ---------------------------------------------------------------------------
# prefill + decode_step against the reference
# ---------------------------------------------------------------------------

# (overrides, prompt length, cache_len, decode steps)
DECODE_CASES = {
    "internlm2-1.8b": ({}, 6, 16, 12),
    "gemma-7b": ({}, 6, 16, 8),
    # a ring of 8: the prompt fits, then 20 steps run far past the window
    "hymba-1.5b": (dict(sliding_window=8), 4, 64, 20),
    # a prompt longer than the ring: prefill keeps the last 8 keys, rolled
    "hymba-1.5b-long-prompt": (dict(sliding_window=8), 13, 64, 10),
    "rwkv6-7b": ({}, 6, 16, 8),
    "granite-moe-1b-a400m": ({}, 6, 16, 8),
    "olmoe-1b-7b": ({}, 6, 16, 8),
}


def _decode_both(ref_model, params, model, prompt, cache_len, steps, seed=0):
    """Prefill and decode both models in lockstep on the same tokens; checks
    every logit and the port's cache against the reference's at the end."""
    rng = np.random.default_rng(seed)
    vocab = model.cfg.vocab_size
    rl, rcache = ref_model.prefill(params, {"tokens": jnp.asarray(prompt, jnp.int32)},
                                   cache_len=cache_len)
    flash, gla = flash_attention.calls, gla_chunked.calls
    pl, cache = model.prefill({"tokens": torch.from_numpy(prompt)}, cache_len=cache_len)
    L = model.cfg.num_layers
    assert (flash_attention.calls - flash, gla_chunked.calls - gla) == (
        L if model.cfg.has_attention else 0, L if model.cfg.has_ssm else 0)
    np.testing.assert_allclose(_np(pl), np.asarray(rl), rtol=LOGIT_TOL, atol=LOGIT_TOL)
    ptrs = {k: v.data_ptr() for k, v in cache.items()}
    decode = jax.jit(ref_model.decode_step)
    for _ in range(steps):
        tok = rng.integers(0, vocab, prompt.shape[0]).astype(np.int32)
        rl, rcache = decode(params, rcache, jnp.asarray(tok))
        pl, cache = model.decode_step(cache, torch.from_numpy(tok))
        np.testing.assert_allclose(_np(pl), np.asarray(rl), rtol=LOGIT_TOL, atol=LOGIT_TOL)
    assert {k: v.data_ptr() for k, v in cache.items()} == ptrs  # written in place
    want = cache_from_arrays(model.cfg, _ref_cache(rcache), device="cpu")
    assert want.keys() == cache.keys()
    assert torch.equal(cache["pos"], want["pos"])
    for name in set(cache) - {"pos"}:
        np.testing.assert_allclose(_np(cache[name]), _np(want[name]),
                                   rtol=LOGIT_TOL, atol=LOGIT_TOL, err_msg=name)
    return cache


@pytest.mark.parametrize("case", sorted(DECODE_CASES))
def test_prefill_and_decode_match_the_reference(case):
    overrides, s, cache_len, steps = DECODE_CASES[case]
    ref_model, params, model = both_models(case.replace("-long-prompt", ""), overrides)
    prompt = np.random.default_rng(s).integers(0, model.cfg.vocab_size, (2, s))
    cache = _decode_both(ref_model, params, model, prompt, cache_len, steps)
    assert cache["pos"].tolist() == [s + steps] * 2


def test_prefill_then_decode_matches_teacher_forcing():
    """The reference's test_decode_matches_teacher_forcing on the port alone:
    the decode logits equal the forward's at each position (hymba: ring and
    state together; MoE dropless in both routes)."""
    for arch, ov in (("hymba-1.5b", dict(sliding_window=8)),
                     ("granite-moe-1b-a400m", dict(capacity_factor=8.0))):
        _, _, model = both_models(arch, ov)
        toks = torch.from_numpy(np.random.default_rng(9).integers(
            0, model.cfg.vocab_size, (1, 20)))
        full, _ = model({"tokens": toks})
        lg, cache = model.prefill({"tokens": toks[:, :6]}, cache_len=32)
        torch.testing.assert_close(lg, full[:, 5], rtol=LOGIT_TOL, atol=LOGIT_TOL)
        for t in range(6, 20):
            lg, cache = model.decode_step(cache, toks[:, t])
            torch.testing.assert_close(lg, full[:, t], rtol=LOGIT_TOL, atol=LOGIT_TOL)


def test_decode_past_cache_len_clamps_like_the_reference():
    """Without a window, a position past the cache writes the last slot again
    and again (``dynamic_update_slice`` clamps its start) and the mask shows
    every slot: reduced internlm2, a cache of 8, decoded to position 18."""
    ref_model, params, model = both_models("internlm2-1.8b")
    prompt = np.random.default_rng(3).integers(0, model.cfg.vocab_size, (2, 6))
    cache = _decode_both(ref_model, params, model, prompt, 8, 12, seed=3)
    assert cache["k"].shape[3] == 8 and cache["pos"].tolist() == [18, 18]


@pytest.mark.parametrize("arch", PORTED)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_cache_spec_is_the_references(arch, dtype):
    from repro.configs import get_config as ref_get_config
    from repro.models import build_model as ref_build_model
    from repro_torch.configs import get_config
    from repro_torch.models import Model
    for window in (0, 8):
        ov = dict(dtype=dtype)
        if get_config(arch).sliding_window:
            ov["sliding_window"] = window or 16
        ref_model = ref_build_model(ref_get_config(arch).reduced(**ov))
        cfg = get_config(arch).reduced(**ov)
        for batch, cache_len in ((1, 5), (3, 40)):
            want = ref_model.cache_spec(batch, cache_len)
            got = cache_spec(cfg, batch, cache_len)
            assert got.keys() == want.keys()
            for name, (shape, dt) in got.items():
                assert shape == tuple(want[name].shape), name
                assert str(dt) == f"torch.{np.dtype(want[name].dtype).name}", name
            cache = Model(cfg, device="cpu").init_cache(batch, cache_len)
            assert {k: (tuple(v.shape), v.dtype) for k, v in cache.items()} == got
            assert all(not v.any() for v in cache.values())


def test_decode_batch_independence():
    """Per-slot positions: one sequence's depth must not affect another's
    output (reference ``tests/test_properties.py``): slot 0 at depth 5, slot
    1 restarted at 0, against a fresh one-slot decode of slot 1's token, and
    against the reference's same two-slot step."""
    ref_model, params, model = both_models("internlm2-1.8b", seed=0)
    toks = np.random.default_rng(2).integers(0, model.cfg.vocab_size, (2, 6)).astype(np.int32)
    cache = model.init_cache(2, 16)
    rcache = ref_model.init_cache(2, 16)
    for t in range(5):
        _, cache = model.decode_step(cache, torch.from_numpy(toks[:, t]))
        _, rcache = ref_model.decode_step(params, rcache, jnp.asarray(toks[:, t]))
    cache["pos"][1] = 0                                     # slot 1 restarts
    rcache = dict(rcache)
    rcache["pos"] = rcache["pos"].at[1].set(0)
    lg, _ = model.decode_step(cache, torch.from_numpy(toks[:, 5]))
    rlg, _ = ref_model.decode_step(params, rcache, jnp.asarray(toks[:, 5]))
    fresh, _ = model.decode_step(model.init_cache(1, 16), torch.from_numpy(toks[1:, 5]))
    np.testing.assert_allclose(_np(lg[1:]), _np(fresh), rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(_np(lg), np.asarray(rlg), rtol=LOGIT_TOL, atol=LOGIT_TOL)


def test_sliding_window_ring_buffer_long_decode():
    """hymba: decoding far past the window keeps the ring at the window and
    the logits the reference's (reference ``tests/test_models.py``)."""
    ref_model, params, model = both_models("hymba-1.5b", dict(sliding_window=8))
    toks = np.random.default_rng(0).integers(0, model.cfg.vocab_size, (1, 4))
    _, cache = model.prefill({"tokens": torch.from_numpy(toks)}, cache_len=64)
    _, rcache = ref_model.prefill(params, {"tokens": jnp.asarray(toks, jnp.int32)},
                                  cache_len=64)
    assert cache["k"].shape[3] == 8                         # ring bounded by the window
    zero = np.zeros((1,), np.int32)
    decode = jax.jit(ref_model.decode_step)
    for _ in range(20):
        lg, cache = model.decode_step(cache, torch.from_numpy(zero))
        rlg, rcache = decode(params, rcache, jnp.asarray(zero))
    assert torch.isfinite(lg).all() and int(cache["pos"][0]) == 24
    np.testing.assert_allclose(_np(lg), np.asarray(rlg), rtol=LOGIT_TOL, atol=LOGIT_TOL)


def _close_bf16(got, want):
    want = np.asarray(want, np.float32)
    scale = np.abs(want).max(axis=-1, keepdims=True)
    assert (np.abs(_np(got) - want) <= 2e-2 * scale).all()


def test_bf16_decode_matches_the_reference():
    """Reduced hymba in bf16 (ring 8, 12 steps past a 10-token prompt)
    against the reference in bf16, within 2e-2 of each row's largest
    |logit|."""
    ref_model, params, model = both_models("hymba-1.5b", dict(
        sliding_window=8, dtype="bfloat16"))
    prompt = np.random.default_rng(5).integers(0, model.cfg.vocab_size, (2, 10))
    rl, rcache = ref_model.prefill(params, {"tokens": jnp.asarray(prompt, jnp.int32)},
                                   cache_len=32)
    pl, cache = model.prefill({"tokens": torch.from_numpy(prompt)}, cache_len=32)
    assert cache["k"].dtype == torch.bfloat16 and cache["ssm"].dtype == torch.float32
    _close_bf16(pl, rl)
    decode = jax.jit(ref_model.decode_step)
    for t in range(12):
        tok = np.full((2,), t, np.int32)
        rl, rcache = decode(params, rcache, jnp.asarray(tok))
        pl, cache = model.decode_step(cache, torch.from_numpy(tok))
        _close_bf16(pl, rl)
