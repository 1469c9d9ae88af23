"""The port's model stack held to the reference's, on the CPU.

The flash and GLA wrappers (CPU route: their plain PyTorch versions) against
the reference's Pallas kernels in interpret mode and its oracles; the
layers; and ``Model.forward`` of reduced hymba, internlm2 and rwkv6 with the
reference's own weights carried over by ``model_params_from_arrays``.
Inputs come from numpy seeds and reach both packages as numpy arrays.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as ref_get_config
from repro.configs import list_architectures as ref_list_architectures
from repro.kernels.flash_attn.ops import flash_attention as ref_flash_attention
from repro.kernels.gla_chunk import gla_chunked as ref_gla_chunked
from repro.models import build_model as ref_build_model
from repro.models import layers as ref_layers
from repro_torch.configs import get_config, list_architectures
from repro_torch.convert import model_params_from_arrays
from repro_torch.kernels.flash_attn import flash_attention
from repro_torch.kernels.gla_chunk import gla_chunked
from repro_torch.models import Model, padded_vocab
from repro_torch.models import layers

from torch_parity import both_models

# (q shape, kv shape, causal, dtype): the reference's flash tests' cases
FLASH_CASES = {
    "causal": ((1, 2, 64, 32), (1, 2, 64, 32), True, np.float32),
    "noncausal": ((1, 2, 96, 64), (1, 2, 96, 64), False, np.float32),
    "gqa_8_2": ((2, 8, 64, 32), (2, 2, 64, 32), True, np.float32),
    "ragged_50_70": ((2, 8, 50, 32), (2, 2, 70, 32), False, np.float32),
    "bf16": ((1, 2, 64, 64), (1, 2, 64, 64), True, jnp.bfloat16),
}
# the reference's own tolerances (tests/test_kernels.py): 2e-3, and 3e-2 for
# bf16, whose outputs round to 8 bits
FLASH_TOL = {np.float32: 2e-3, jnp.bfloat16: 3e-2}


def _qkv(seed, q_shape, kv_shape):
    rng = np.random.default_rng(seed)
    return (rng.normal(0, 1, q_shape).astype(np.float32),
            rng.normal(0, 1, kv_shape).astype(np.float32),
            rng.normal(0, 1, kv_shape).astype(np.float32))


def _port(a, dtype=np.float32):
    """A numpy array as the port's CPU tensor, in the reference's dtype."""
    t = torch.from_numpy(np.ascontiguousarray(a, dtype=np.float32))
    return t.to(torch.bfloat16) if dtype == jnp.bfloat16 else t


@pytest.mark.parametrize("case", sorted(FLASH_CASES))
def test_flash_plain_version_matches_the_pallas_kernel(case):
    q_shape, kv_shape, causal, dtype = FLASH_CASES[case]
    q, k, v = _qkv(5, q_shape, kv_shape)
    want = ref_flash_attention(*(jnp.asarray(x).astype(dtype) for x in (q, k, v)),
                               causal=causal, bq=32, bk=32, interpret=True)
    calls, launches = flash_attention.calls, flash_attention.launches
    got = flash_attention(*(_port(x, dtype) for x in (q, k, v)), causal=causal)
    assert (flash_attention.calls, flash_attention.launches) == (calls + 1, launches)
    assert got.shape == q_shape and got.dtype == _port(q, dtype).dtype
    tol = FLASH_TOL[dtype]
    np.testing.assert_allclose(got.float().numpy(), np.asarray(want, np.float32),
                               rtol=tol, atol=tol)


@pytest.mark.parametrize("causal", [True, False])
def test_flash_window_matches_mea_attention(causal):
    """The sliding window of hymba's attention: the plain version against the
    reference's ``mea_attention`` at window 16 over 48 positions, GQA 4/2.
    Both are f32 softmax attention over the same keys; 1e-5 covers the
    different summation orders (measured 1.3e-6)."""
    q, k, v = _qkv(11, (2, 4, 48, 16), (2, 2, 48, 16))
    want = np.asarray(ref_layers.mea_attention(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), causal=causal, window=16))
    got = layers.mea_attention(torch.from_numpy(q), torch.from_numpy(k),
                               torch.from_numpy(v), causal=causal, window=16)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-5)
    unwindowed = layers.mea_attention(torch.from_numpy(q), torch.from_numpy(k),
                                      torch.from_numpy(v), causal=causal)
    assert np.abs(unwindowed.numpy() - want).max() > 1e-2  # the window binds


@pytest.mark.parametrize("window,passes", [(1024, True), (1023, False), (1025, False)])
def test_bf16_flash_limit_rejects_a_window_off_by_one(window, passes):
    """The limit the kernel's bf16 output is held to on the card (rtol 1e-2,
    atol 1e-4: one bf16 step) at hymba's window of 1024 and |o| ~ 0.04: an
    f32 result off by f32 noise and rounded once passes; a window one key
    short or long does not."""
    rng = np.random.default_rng(17)
    q, k, v = (torch.from_numpy(x).to(torch.bfloat16)
               for x in _qkv(17, (1, 5, 1100, 64), (1, 1, 1100, 64)))
    want = flash_attention(q, k, v, window=1024).float()
    exact = flash_attention(q.float(), k.float(), v.float(), window=window)
    noise = torch.from_numpy(rng.standard_normal(exact.shape).astype(np.float32))
    got = (exact * (1 + 1e-6 * noise)).to(torch.bfloat16).float()
    ok = ((got - want).abs() <= 1e-4 + 1e-2 * want.abs()).all()
    assert bool(ok) == passes


def _attention_p_in_parts(q, k, v, window, parts):
    """The bf16 flash kernel's arithmetic on the CPU: f32 scores, softmax
    weights p in f32 and l their f32 sum, P V with P given as ``parts`` bf16
    pieces (1: bf16(p); 2: bf16(p) + bf16(p - bf16(p))), o = P V / l rounded
    once to bf16."""
    hq, hkv, s, d = q.shape[1], k.shape[1], q.shape[2], q.shape[3]
    kv_head = torch.arange(hq) // (hq // hkv)
    kf, vf = (x.float().index_select(1, kv_head) for x in (k, v))
    scores = torch.matmul(q.float(), kf.transpose(-1, -2)) / d ** 0.5
    rows, cols = torch.arange(s)[:, None], torch.arange(s)[None, :]
    scores = scores.masked_fill(~((cols <= rows) & (cols > rows - window)), -1e30)
    p = torch.exp(scores - scores.amax(dim=-1, keepdim=True))
    pv = torch.zeros(q.shape)
    rest = p
    for _ in range(parts):
        piece = rest.to(torch.bfloat16).float()
        pv += torch.matmul(piece, vf)
        rest = rest - piece
    return (pv / p.sum(dim=-1, keepdim=True)).to(torch.bfloat16)


@pytest.mark.parametrize("parts,passes", [(1, False), (2, True)])
def test_bf16_flash_p_in_two_parts_meets_the_limit(parts, passes):
    """Why the tensor-core kernel feeds P to P V as two bf16 parts: at a
    reduced eval shape (B 2, 10 q over 2 kv heads, 1024 tokens, d 64, window
    512, bf16), P rounded once to bf16 (off by up to 2^-8 p) fails the
    unchanged bf16 limit (rtol 1e-2, atol 1e-4) wherever |o| is small,
    against the plain version; P_hi + P_lo (16 bits of p) meets it."""
    q, k, v = (torch.from_numpy(x).to(torch.bfloat16)
               for x in _qkv(23, (2, 10, 1024, 64), (2, 2, 1024, 64)))
    want = flash_attention(q, k, v, window=512).float()
    got = _attention_p_in_parts(q, k, v, 512, parts).float()
    ok = ((got - want).abs() <= 1e-4 + 1e-2 * want.abs()).all()
    assert bool(ok) == passes


@pytest.mark.parametrize("T", [100, 128])
@pytest.mark.parametrize("dk,dv", [(16, 64), (64, 64)])
def test_gla_plain_version_matches_the_pallas_kernel_and_recurrence(T, dk, dv):
    """o and the final state against the reference's Pallas kernel
    (interpret mode, chunk 64) and its sequential recurrence; T = 100 is off
    the chunk and some decays lie below the -8 clamp.  3e-3: the reference's
    own tolerance between its kernel and its recurrence."""
    rng = np.random.default_rng(T + dk)
    q = rng.normal(0, 1, (1, 2, T, dk)).astype(np.float32)
    k = rng.normal(0, 1, (1, 2, T, dk)).astype(np.float32)
    v = rng.normal(0, 1, (1, 2, T, dv)).astype(np.float32)
    g = -rng.uniform(0.001, 0.2, (1, 2, T, dk)).astype(np.float32)
    g[:, :, 5:9] = -9.5                                  # clamped to -8
    jx = [jnp.asarray(x) for x in (q, k, v, g)]
    o_kernel, s_kernel = ref_gla_chunked(*jx, chunk=64, interpret=True)
    o_rec, s_rec = ref_gla_chunked(*jx, use_ref=True)
    calls = gla_chunked.calls
    o, s = gla_chunked(*(torch.from_numpy(x) for x in (q, k, v, g)))
    assert gla_chunked.calls == calls + 1
    assert o.shape == (1, 2, T, dv) and s.shape == (1, 2, dk, dv)
    for want_o, want_s in ((o_kernel, s_kernel), (o_rec, s_rec)):
        np.testing.assert_allclose(o.numpy(), np.asarray(want_o), rtol=3e-3, atol=3e-3)
        np.testing.assert_allclose(s.numpy(), np.asarray(want_s), rtol=3e-3, atol=3e-3)


def test_gla_clamp_makes_strong_decays_equal():
    """Decays at and below -8 give the same answer: the clamp is applied."""
    rng = np.random.default_rng(3)
    q, k = (torch.from_numpy(rng.normal(0, 1, (1, 1, 40, 16)).astype(np.float32))
            for _ in range(2))
    v = torch.from_numpy(rng.normal(0, 1, (1, 1, 40, 64)).astype(np.float32))
    a = gla_chunked(q, k, v, torch.full_like(q, -8.0))
    b = gla_chunked(q, k, v, torch.full_like(q, -30.0))
    assert torch.equal(a[0], b[0]) and torch.equal(a[1], b[1])


def test_layers_match_the_reference():
    """rms_norm, rope and mlp_block (swiglu and geglu) at 1e-6."""
    rng = np.random.default_rng(12)
    x = rng.normal(0, 1, (2, 3, 40, 16)).astype(np.float32)
    w = rng.normal(0, 0.1, (16,)).astype(np.float32)
    np.testing.assert_allclose(
        layers.rms_norm(torch.from_numpy(x), torch.from_numpy(w), 1e-5).numpy(),
        np.asarray(ref_layers.rms_norm(jnp.asarray(x), jnp.asarray(w), 1e-5)),
        rtol=1e-6, atol=1e-6)
    pos = np.arange(40)
    np.testing.assert_allclose(
        layers.rope(torch.from_numpy(x), torch.from_numpy(pos), 1e4).numpy(),
        np.asarray(ref_layers.rope(jnp.asarray(x), jnp.asarray(pos), 1e4)),
        rtol=1e-6, atol=1e-6)
    h = rng.normal(0, 1, (2, 5, 16)).astype(np.float32)
    w1, w3 = (rng.normal(0, 0.25, (16, 24)).astype(np.float32) for _ in range(2))
    w2 = rng.normal(0, 0.2, (24, 16)).astype(np.float32)
    for kind in ("swiglu", "geglu"):
        np.testing.assert_allclose(
            layers.mlp_block(*(torch.from_numpy(a) for a in (h, w1, w2, w3)), kind).numpy(),
            np.asarray(ref_layers.mlp_block(*(jnp.asarray(a) for a in (h, w1, w2, w3)), kind)),
            rtol=1e-6, atol=1e-6)


# (arch, reduced overrides, sequence): hymba's window binds at 48 > 16
FORWARD_CASES = {
    "hymba-1.5b": (dict(sliding_window=16), 48),
    "internlm2-1.8b": ({}, 40),
    "rwkv6-7b": ({}, 70),
}


@pytest.mark.parametrize("arch", sorted(FORWARD_CASES))
def test_forward_matches_the_reference(arch):
    """Logits of the reduced config (f32, 2 layers, width 64) with the
    reference's weights, against the reference's forward.  2e-5: both run
    the same f32 arithmetic in different orders (chunked scans of 32 against
    the port's chunks of 64 for GLA, online against dense softmax); the
    largest gap measured is 7.4e-6 on logits of magnitude ~4."""
    overrides, seq = FORWARD_CASES[arch]
    ref_model, params, model = both_models(arch, overrides)
    tokens = np.random.default_rng(0).integers(0, model.cfg.vocab_size, (2, seq))
    want, _ = ref_model.forward(params, {"tokens": jnp.asarray(tokens, jnp.int32)})
    flash, gla = flash_attention.calls, gla_chunked.calls
    got, aux = model({"tokens": torch.from_numpy(tokens)})
    L = model.cfg.num_layers
    assert (flash_attention.calls - flash, gla_chunked.calls - gla) == (
        L if model.cfg.has_attention else 0, L if model.cfg.has_ssm else 0)
    assert got.shape == (2, seq, padded_vocab(model.cfg)) and float(aux) == 0.0
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=2e-5, atol=2e-5)


def test_weights_carry_over_bit_for_bit_in_bf16():
    """A bf16 parameter tree comes across with its bits unchanged."""
    ref_cfg = ref_get_config("hymba-1.5b").reduced(dtype="bfloat16")
    params = ref_build_model(ref_cfg).init(jax.random.PRNGKey(2))
    cfg = get_config("hymba-1.5b").reduced(dtype="bfloat16")
    state = model_params_from_arrays(cfg, jax.tree.map(np.asarray, params),
                                     device="cpu")
    model = Model(cfg, device="cpu")
    model.load_state_dict(state)
    for name, p in model.state_dict().items():
        ref = params["layers"][name.split(".", 1)[1]] if "." in name else params[name]
        assert p.dtype == torch.bfloat16
        assert np.array_equal(p.view(torch.int16).numpy(),
                              np.asarray(ref).view(np.int16)), name


def test_init_draws_the_reference_distributions():
    cfg = get_config("hymba-1.5b").reduced(d_model=128, d_ff=256)
    model = Model(cfg, device="cpu").init(torch.Generator().manual_seed(0))
    lay = model.layers
    assert padded_vocab(cfg) % 128 == 0 and model.embed.shape[0] == padded_vocab(cfg)
    assert not lay["ln1"].any() and not lay["ln2"].any() and not model.final_norm.any()
    assert torch.equal(lay["s_gbias"], torch.full_like(lay["s_gbias"], -1.0))
    for name, p in lay.items():
        if p.dim() == 3:  # matrices: N(0, 1) * fan_in^-0.5
            assert float(p.std()) == pytest.approx(p.shape[1] ** -0.5, rel=0.05), name
    assert float(model.embed.std()) == pytest.approx(0.02, rel=0.05)
    assert float(model.head.std()) == pytest.approx(128 ** -0.5, rel=0.05)
    again = Model(cfg, device="cpu").init(torch.Generator().manual_seed(0))
    assert all(torch.equal(a, b) for a, b in zip(model.state_dict().values(),
                                                 again.state_dict().values()))


def test_configs_are_the_reference_configs():
    """The registry and every config, field for field."""
    assert list_architectures() == ref_list_architectures()
    for arch in list_architectures():
        assert dataclasses.asdict(get_config(arch)) == \
            dataclasses.asdict(ref_get_config(arch))
        assert dataclasses.asdict(get_config(arch).reduced()) == \
            dataclasses.asdict(ref_get_config(arch).reduced())


def test_wrappers_check_their_inputs():
    q = torch.zeros(1, 4, 8, 16)
    kv = torch.zeros(1, 2, 8, 16)
    with pytest.raises(NotImplementedError, match="prefill"):
        flash_attention(q, kv, kv, q_offset=3)
    with pytest.raises(ValueError, match="contiguous"):
        flash_attention(q.transpose(1, 2).contiguous().transpose(1, 2), kv, kv)
    with pytest.raises(ValueError, match="multiple"):
        flash_attention(torch.zeros(1, 3, 8, 16), kv, kv)
    with pytest.raises(TypeError, match="bfloat16"):
        flash_attention(q.half(), kv.half(), kv.half())
    with pytest.raises(ValueError, match="cuda or cpu"):
        flash_attention(q.to("meta"), kv.to("meta"), kv.to("meta"))
    g = torch.zeros(1, 2, 8, 16)
    v = torch.zeros(1, 2, 8, 64)
    with pytest.raises(ValueError, match="contiguous"):
        gla_chunked(g, g, v.transpose(2, 3).contiguous().transpose(2, 3), g)
    with pytest.raises(ValueError, match="does not match"):
        gla_chunked(g, g, torch.zeros(1, 2, 9, 64), g)
    with pytest.raises(ValueError, match="cuda or cpu"):
        gla_chunked(*(t.to("meta") for t in (g, g, v, g)))
