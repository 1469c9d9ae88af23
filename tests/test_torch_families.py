"""The encoder-decoder and VLM families of the port against the reference's,
on the CPU: whisper-large-v3 and llava-next-34b ``.reduced()`` (f32, 2
layers, width 64; whisper's 2 encoder layers over 24 frames, llava's 8
patches), with the reference's weights carried over by ``convert``.  The
batches are built from the port's ``launch.specs.batch_specs`` and filled
from numpy seeds; both packages get the same arrays.

Tolerances:
- logits (forward, prefill, decode) and every cache tensor within 5e-5,
  as ``test_torch_decode.py`` holds the other families: the same f32
  arithmetic in other orders (online against dense softmax);
- one ``make_train_step`` at ``test_torch_train.py``'s tolerances: the
  loss within rtol 1e-5, every gradient leaf within 1e-4 of its scale, the
  parameters within 1e-5 of theirs after AdamW and the moments within 1e-4;
- a checkpoint written by the port: the reference's leaf names and values
  bit for bit;
- every config of the registry builds at full width (on the meta device)
  with the reference's parameter names, shapes and dtypes, exactly.
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.train import checkpoint as ref_ckpt
from repro.train import optimizer as ref_opt
from repro.train import step as ref_step
from repro_torch.configs import list_architectures
from repro_torch.convert import _tree_to_arrays, cache_from_arrays, train_state_to_arrays
from repro_torch.kernels.flash_attn import flash_attention
from repro_torch.models import padded_vocab
from repro_torch.train import checkpoint as ckpt
from repro_torch.train import optimizer, step
from torch_parity import assert_tree_close, both_models, both_train_states, spec_batch

jax.config.update("jax_default_matmul_precision", "highest")

ARCHS = ("whisper-large-v3", "llava-next-34b")
LOGIT_TOL = 5e-5
# AdamW eps 1e-3, as test_torch_train.py compares parameters after a step
OPT = dict(lr=3e-3, warmup_steps=0, eps=1e-3)


def _torch(b):
    return {k: torch.from_numpy(v.copy()) for k, v in b.items()}


def _jax(b):
    return {k: jnp.asarray(v.copy()) for k, v in b.items()}


def _np(t):
    return t.detach().float().numpy()


def _flash_calls(cfg):
    """flash calls of one forward: the encoder's self-attention, and each
    decoder layer's self- and cross-attention."""
    if cfg.family == "encdec":
        return cfg.encoder_layers + 2 * cfg.num_layers
    return cfg.num_layers


@pytest.mark.parametrize("arch", ARCHS)
def test_forward_matches_the_reference(arch):
    ref_model, params, model = both_models(arch)
    cfg = model.cfg
    b = spec_batch(cfg, "prefill", 2, 20, seed=0)
    want, want_aux = ref_model.forward(params, _jax(b))
    calls = flash_attention.calls
    got, aux = model(_torch(b))
    assert flash_attention.calls - calls == _flash_calls(cfg)
    # a VLM's 12 text tokens follow its 8 patches: logits over all 20
    assert got.shape == (2, 20, padded_vocab(cfg)) and float(aux) == float(want_aux) == 0.0
    np.testing.assert_allclose(_np(got), np.asarray(want), rtol=LOGIT_TOL, atol=LOGIT_TOL)


# (arch, cache_len): a cache that holds the prompt and the steps; and llava
# at the default cache_len, the text length, which the P + S prefilled keys
# overrun (the reference keeps the last S and every decode step writes the
# clamped last slot)
PREFILL_CASES = [("whisper-large-v3", 16), ("llava-next-34b", 24), ("llava-next-34b", None)]


@pytest.mark.parametrize("arch,cache_len", PREFILL_CASES)
def test_prefill_and_decode_match_the_reference(arch, cache_len):
    """prefill's logits and cache (k, v, cross_k, cross_v, pos), then three
    decode steps' logits and the cache after them."""
    ref_model, params, model = both_models(arch)
    cfg = model.cfg
    b = spec_batch(cfg, "prefill", 2, 14, seed=1)
    text = b["tokens"].shape[1]
    rl, rcache = ref_model.prefill(params, _jax(b), cache_len=cache_len)
    pl, cache = model.prefill(_torch(b), cache_len=cache_len)
    np.testing.assert_allclose(_np(pl), np.asarray(rl), rtol=LOGIT_TOL, atol=LOGIT_TOL)
    n = text + (cfg.num_patches if cfg.family == "vlm" else 0)
    assert cache["pos"].tolist() == [n, n]

    def same_cache(cache, rcache):
        want = cache_from_arrays(cfg, jax.tree.map(np.asarray, rcache), device="cpu")
        assert want.keys() == cache.keys()
        assert torch.equal(cache["pos"], want["pos"])
        for name in set(cache) - {"pos"}:
            np.testing.assert_allclose(_np(cache[name]), _np(want[name]), rtol=LOGIT_TOL,
                                       atol=LOGIT_TOL, err_msg=name)

    same_cache(cache, rcache)
    if cfg.family == "encdec":
        assert cache["cross_k"].shape[3] == cfg.enc_seq
    decode = jax.jit(ref_model.decode_step)
    rng = np.random.default_rng(2)
    for _ in range(3):
        tok = rng.integers(0, cfg.vocab_size, 2).astype(np.int32)
        rl, rcache = decode(params, rcache, jnp.asarray(tok))
        pl, cache = model.decode_step(cache, torch.from_numpy(tok))
        np.testing.assert_allclose(_np(pl), np.asarray(rl), rtol=LOGIT_TOL, atol=LOGIT_TOL)
    same_cache(cache, rcache)
    assert cache["pos"].tolist() == [n + 3] * 2


@pytest.mark.parametrize("arch", ARCHS)
def test_one_train_step_matches_the_reference(arch):
    """The loss and every gradient (encoder leaves included), then one
    make_train_step against the reference's jitted step."""
    ref_model, ref_state, model, state = both_train_states(arch)
    cfg, vocab = model.cfg, model.cfg.vocab_size
    b = spec_batch(cfg, "train", 2, 16, seed=3)
    jb = _jax(b)
    assert b["labels"].shape == (2, 16)

    def ref_loss(params):
        logits, aux = ref_model.forward(params, jb)
        return ref_step.cross_entropy(logits, jb["labels"], vocab) + 0.01 * aux

    want_loss, want_grads = jax.value_and_grad(ref_loss)(ref_state.params)
    tb = _torch(b)
    logits, aux = model(tb)
    loss = step.cross_entropy(logits, tb["labels"], vocab) + 0.01 * aux
    names = [n for n, _ in model.named_parameters()]
    grads = torch.autograd.grad(loss, list(model.parameters()))
    np.testing.assert_allclose(float(loss.detach()), float(want_loss), rtol=1e-5)
    assert_tree_close(_tree_to_arrays(dict(zip(names, grads))),
                       jax.tree.map(np.asarray, want_grads), 1e-4, "grads")

    new_ref, rm = jax.jit(ref_step.make_train_step(ref_model, ref_opt.AdamWConfig(**OPT)))(
        ref_state, jb)
    new, m = step.make_train_step(model, optimizer.AdamWConfig(**OPT))(state, tb)
    np.testing.assert_allclose(float(m["loss"]), float(rm["loss"]), rtol=1e-5)
    np.testing.assert_allclose(float(m["grad_norm"]), float(rm["grad_norm"]), rtol=1e-5)
    params, opt, _ = train_state_to_arrays(new)
    assert_tree_close(params, jax.tree.map(np.asarray, new_ref.params), 1e-5, "params")
    assert_tree_close(opt["mu"], jax.tree.map(np.asarray, new_ref.opt.mu), 1e-4, "mu")
    assert_tree_close(opt["nu"], jax.tree.map(np.asarray, new_ref.opt.nu), 1e-4, "nu")


@pytest.mark.parametrize("arch", ARCHS)
def test_microbatched_step_splits_frames_and_patches(arch):
    """microbatches=2: the strided split takes every batch key (frames,
    patch_embeds), as the reference's: two steps, losses within rtol 1e-5
    and the parameters within 1e-5 of their scale after each."""
    ref_model, ref_state, model, state = both_train_states(arch)
    cfg = ref_opt.AdamWConfig(**OPT)
    ref_fn = jax.jit(ref_step.make_train_step(ref_model, cfg, microbatches=2))
    fn = step.make_train_step(model, optimizer.AdamWConfig(**OPT), microbatches=2)
    for i in range(2):
        b = spec_batch(model.cfg, "train", 4, 12, seed=10 + i)
        ref_state, rm = ref_fn(ref_state, _jax(b))
        state, m = fn(state, _torch(b))
        np.testing.assert_allclose(float(m["loss"]), float(rm["loss"]), rtol=1e-5)
        assert_tree_close(train_state_to_arrays(state)[0],
                           jax.tree.map(np.asarray, ref_state.params), 1e-5, f"step {i}")


@pytest.mark.parametrize("arch", ARCHS)
def test_checkpoint_written_by_the_port_reads_in_the_reference(tmp_path, arch):
    """The port's TrainState (enc_layers and enc_norm included) written in
    the reference's layout: the reference's leaf names, and its restore
    gives back the port's values bit for bit; the port restores it into a
    fresh state."""
    ref_model, ref_state, model, state = both_train_states(arch)
    b = spec_batch(model.cfg, "train", 2, 12, seed=5)
    state, _ = step.make_train_step(model, optimizer.AdamWConfig(**OPT))(state, _torch(b))
    names = [n for n, _ in ckpt._flatten(state)]
    assert names == ref_ckpt._flatten(ref_state)[1]
    if model.cfg.family == "encdec":
        assert ".params__enc_layers__wq" in names and ".params__enc_norm" in names
    ckpt.save(str(tmp_path), 1, state)
    assert os.path.exists(tmp_path / "step_00000001" / ".params__layers__wq.npy")
    back, _ = ref_ckpt.restore(str(tmp_path), 1, ref_state)
    params, opt, _ = train_state_to_arrays(state)
    for got, want in ((back.params, params), (back.opt.mu, opt["mu"]),
                      (back.opt.nu, opt["nu"])):
        for x, y in zip(jax.tree.leaves(got), jax.tree.leaves(want)):
            assert np.array_equal(np.asarray(x), y)
    assert int(back.opt.step) == 1
    _, _, _, fresh = both_train_states(arch)
    ckpt.restore(str(tmp_path), 1, fresh)
    for n, p in fresh.params.items():
        assert torch.equal(p, state.params[n]), n


@pytest.mark.parametrize("arch", list_architectures())
def test_every_registry_config_builds_at_full_width(monkeypatch, arch):
    """``Model(get_config(arch))`` at full width, on PyTorch's meta device (no
    storage): every parameter's name, shape and dtype are the reference's
    ``init_abstract()`` leaf's (exact), encoder and cross weights included."""
    from repro.configs import get_config as ref_get_config
    from repro.models import build_model as ref_build_model
    from repro_torch.configs import get_config
    from repro_torch.models import Model
    from repro_torch.models import model as model_mod

    monkeypatch.setattr(model_mod, "resolve_device", lambda device: torch.device("meta"))
    model = Model(get_config(arch))
    want = ref_build_model(ref_get_config(arch)).init_abstract()
    flat = {}
    for name, leaf in want.items():
        if isinstance(leaf, dict):
            flat.update({f"{name}.{k}": v for k, v in leaf.items()})
        else:
            flat[name] = leaf
    got = dict(model.named_parameters())
    assert sorted(got) == sorted(flat)
    for name, p in got.items():
        assert tuple(p.shape) == tuple(flat[name].shape), name
        assert str(p.dtype)[6:] == str(flat[name].dtype), name
