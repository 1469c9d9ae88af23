"""Two-level remat (``cfg.remat_groups``) of the port, on the CPU: reduced
configs cut to 4 layers, with the reference's weights carried over.

- With G in {2, L} groups the gradients of every parameter are bitwise the
  per-block run's (``remat_groups`` 0): the same operations run on the same
  inputs, only more of them again in the backward.  So they are with
  ``remat`` off, where only the group checkpoint applies.
- They are within 1e-4 of each leaf's scale of the reference's gradients
  at the same G (``test_torch_train.py``'s gradient tolerance: flash and
  GLA through the port's backward, sums in other orders), and the loss
  within rtol 1e-5.
- G that does not divide L takes the per-block path: no group checkpoint.
"""

import jax
import numpy as np
import pytest
import torch

from repro.train import step as ref_step
from repro_torch.convert import _tree_to_arrays
from repro_torch.models import model as model_mod
from repro_torch.train import step
from torch_parity import both_models

jax.config.update("jax_default_matmul_precision", "highest")

L = 4
ARCHS = ("internlm2-1.8b", "hymba-1.5b", "granite-moe-1b-a400m", "whisper-large-v3")


def _batch(cfg, seed=4):
    rng = np.random.default_rng(seed)
    toks = rng.integers(0, cfg.vocab_size, (2, 17)).astype(np.int32)
    b = {"tokens": toks[:, :-1], "labels": toks[:, 1:]}
    if cfg.family == "encdec":
        b["frames"] = rng.standard_normal((2, cfg.enc_seq, cfg.d_model)).astype(np.float32)
    return b


def _grads(model, b, counts=None):
    """(loss, grads by state-dict name) of one forward and backward; with
    ``counts``, the checkpoint calls of the forward by function name."""
    saved = model_mod.checkpoint
    if counts is not None:
        def counted(fn, *args, **kw):
            counts[fn.__name__] = counts.get(fn.__name__, 0) + 1
            return saved(fn, *args, **kw)
        model_mod.checkpoint = counted
    try:
        tb = {k: torch.from_numpy(v.copy()) for k, v in b.items()}
        model.requires_grad_(True)
        logits, aux = model(tb)
        loss = step.cross_entropy(logits, tb["labels"], model.cfg.vocab_size) + 0.01 * aux
    finally:
        model_mod.checkpoint = saved
    names = [n for n, _ in model.named_parameters()]
    return loss.detach(), dict(zip(names, torch.autograd.grad(loss, list(model.parameters()))))


@pytest.mark.parametrize("groups", [2, L])
@pytest.mark.parametrize("arch", ARCHS)
def test_grouped_remat_gradients_are_bitwise_per_block(arch, groups):
    _, _, per_block = both_models(arch, {"num_layers": L})
    ref_model, params, grouped = both_models(arch, {"num_layers": L, "remat_groups": groups})
    b = _batch(grouped.cfg)
    loss0, g0 = _grads(per_block, b)
    counts = {}
    loss, g = _grads(grouped, b, counts)
    # the forward: G group checkpoints, each running its L / G per-block ones
    assert counts == {"_blocks": groups, "_train_block": L,
                      **({"_encoder_block": 2} if arch == "whisper-large-v3" else {})}
    assert torch.equal(loss, loss0)
    for n in g0:
        assert torch.equal(g[n], g0[n]), n

    jb = {k: jax.numpy.asarray(v.copy()) for k, v in b.items()}

    def ref_loss(p):
        logits, aux = ref_model.forward(p, jb)
        return ref_step.cross_entropy(logits, jb["labels"], grouped.cfg.vocab_size) + 0.01 * aux

    want_loss, want = jax.value_and_grad(ref_loss)(params)
    np.testing.assert_allclose(float(loss), float(want_loss), rtol=1e-5)
    got, want = _tree_to_arrays(g), jax.tree.map(np.asarray, want)
    for stack in [k for k in want if isinstance(want[k], dict)]:
        for name, w in want[stack].items():
            err = np.abs(got[stack][name].astype(np.float64) - w).max()
            assert err <= 1e-4 * max(np.abs(w).max(), 1.0), (stack, name, err)
    for name in [k for k in want if not isinstance(want[k], dict)]:
        err = np.abs(got[name].astype(np.float64) - want[name]).max()
        assert err <= 1e-4 * max(np.abs(want[name]).max(), 1.0), (name, err)


def test_grouped_checkpoint_applies_without_remat():
    """remat off: only the group checkpoints run, and the gradients are
    bitwise the run with no checkpoint at all."""
    _, _, plain = both_models("hymba-1.5b", {"num_layers": L, "remat": False})
    _, _, grouped = both_models("hymba-1.5b", {"num_layers": L, "remat": False,
                                               "remat_groups": 2})
    b = _batch(plain.cfg)
    counts0, counts = {}, {}
    _, g0 = _grads(plain, b, counts0)
    _, g = _grads(grouped, b, counts)
    assert counts0 == {} and counts == {"_blocks": 2}
    for n in g0:
        assert torch.equal(g[n], g0[n]), n


@pytest.mark.parametrize("groups", [3, 8])
def test_groups_that_do_not_divide_the_depth_take_the_per_block_path(groups):
    _, _, per_block = both_models("internlm2-1.8b", {"num_layers": L})
    _, _, model = both_models("internlm2-1.8b", {"num_layers": L, "remat_groups": groups})
    b = _batch(model.cfg)
    counts = {}
    _, g0 = _grads(per_block, b)
    _, g = _grads(model, b, counts)
    assert counts == {"_train_block": L}
    for n in g0:
        assert torch.equal(g[n], g0[n]), n
