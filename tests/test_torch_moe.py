"""The port's mixture-of-experts FFN (``repro_torch.models.moe``) held to the
reference's ``models/moe.py``, on the CPU.

Inputs come from numpy seeds and reach both packages as numpy arrays.  Both
sides compute in f32 from the same inputs, so outputs are held at 1e-5 and
the aux loss at 1e-6; a token routed or dropped differently would move its
row by O(1), far outside those.  The MoE model's logits are held at 5e-5,
as the other models' are (``test_torch_decode.py``).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import moe as ref_moe
from repro_torch.models import moe

from torch_parity import both_models

T, D, E, F = 48, 32, 8, 24


def _weights(seed, e=E, scale=1.0):
    rng = np.random.default_rng(seed)
    x = rng.normal(0, 1, (T, D)).astype(np.float32)
    router = (rng.normal(0, 1, (D, e)) * scale).astype(np.float32)
    w1, w3 = (rng.normal(0, D ** -0.5, (e, D, F)).astype(np.float32) for _ in range(2))
    w2 = rng.normal(0, F ** -0.5, (e, F, D)).astype(np.float32)
    return x, router, w1, w3, w2


def _both(fn_ref, fn, arrays, **kw):
    want = fn_ref(*(jnp.asarray(a) for a in arrays), **kw)
    got = fn(*(torch.from_numpy(a) for a in arrays), **kw)
    return got, want


@pytest.mark.parametrize("top_k", [1, 2, 4])
@pytest.mark.parametrize("mlp_kind", ["swiglu", "geglu"])
def test_moe_ffn_matches_the_reference(top_k, mlp_kind):
    arrays = _weights(top_k)
    (y, aux), (ry, raux) = _both(ref_moe.moe_ffn, moe.moe_ffn, arrays, top_k=top_k,
                                 capacity_factor=1.25, mlp_kind=mlp_kind)
    assert y.shape == (T, D) and aux.dtype == torch.float32
    np.testing.assert_allclose(y.numpy(), np.asarray(ry), rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(float(aux), float(raux), rtol=1e-6)


@pytest.mark.parametrize("top_k", [1, 2, 4])
def test_moe_ffn_dense_matches_the_reference(top_k):
    arrays = _weights(10 + top_k)
    y, ry = _both(ref_moe.moe_ffn_dense, moe.moe_ffn_dense, arrays, top_k=top_k)
    np.testing.assert_allclose(y.numpy(), np.asarray(ry), rtol=1e-5, atol=1e-5)


def test_low_capacity_drops_the_same_tokens():
    """capacity_factor 0.25: 3 slots per expert for 96 pairs, so most pairs
    drop; the kept pairs are the first of each expert in token order (the
    stable sort), the same as the reference's."""
    arrays = _weights(7)
    (y, aux), (ry, raux) = _both(ref_moe.moe_ffn, moe.moe_ffn, arrays, top_k=2,
                                 capacity_factor=0.25)
    ry = np.asarray(ry)
    dropped = (y == 0).all(dim=-1).numpy()
    assert 0 < dropped.sum() < T
    np.testing.assert_array_equal(dropped, (ry == 0).all(axis=-1))
    np.testing.assert_allclose(y.numpy(), ry, rtol=1e-5, atol=1e-5)
    # the first tokens keep their slots; the late ones were dropped
    assert not dropped[:3].any() and dropped[-8:].all()


def test_top_k_ties_keep_the_lower_expert_first():
    """Equal router columns give equal probabilities; ``jax.lax.top_k`` keeps
    the lower expert index first, and so must the port."""
    x, router, w1, w3, w2 = _weights(3)
    router[:, :] = router[:, :1]                       # every expert ties
    _, gates, experts = moe._route(torch.from_numpy(x), torch.from_numpy(router), 3)
    assert (experts == torch.tensor([0, 1, 2])).all()
    for fn_ref, fn, kw in ((ref_moe.moe_ffn, moe.moe_ffn, dict(capacity_factor=1.0)),
                           (ref_moe.moe_ffn_dense, moe.moe_ffn_dense, {})):
        out, want = _both(fn_ref, fn, (x, router, w1, w3, w2), top_k=3, **kw)
        if isinstance(out, tuple):
            out, want = out[0], want[0]
        np.testing.assert_allclose(out.numpy(), np.asarray(want), rtol=1e-5, atol=1e-5)


def test_dropless_dispatch_equals_dense():
    """With room for every pair the sort-based dispatch computes exactly the
    dense route's function."""
    arrays = [torch.from_numpy(a) for a in _weights(5)]
    y, _ = moe.moe_ffn(*arrays, top_k=2, capacity_factor=E / 2)
    dense = moe.moe_ffn_dense(*arrays, top_k=2)
    torch.testing.assert_close(y, dense, rtol=1e-5, atol=1e-5)


def test_token_permutation_equivariance():
    """Dropless, each token's output depends on that token alone: permuting
    the tokens permutes the outputs; the aux loss is unchanged."""
    x, router, w1, w3, w2 = (torch.from_numpy(a) for a in _weights(6))
    perm = torch.from_numpy(np.random.default_rng(0).permutation(T))
    y, aux = moe.moe_ffn(x, router, w1, w3, w2, top_k=2, capacity_factor=E / 2)
    yp, auxp = moe.moe_ffn(x[perm], router, w1, w3, w2, top_k=2, capacity_factor=E / 2)
    torch.testing.assert_close(yp, y[perm], rtol=1e-6, atol=1e-6)
    torch.testing.assert_close(auxp, aux, rtol=1e-6, atol=1e-7)


def test_bf16_moe_ffn_near_the_reference():
    """bf16 inputs: the same routing (gates in f32 on both sides), outputs
    within 2e-2 of the row's largest |y| (a few bf16 steps; the port sums a
    token's pairs in slot order, the reference in expert order)."""
    arrays = _weights(8)
    jx = [jnp.asarray(a).astype(jnp.bfloat16) for a in arrays]
    ry, _ = ref_moe.moe_ffn(*jx, top_k=2, capacity_factor=1.25)
    y, _ = moe.moe_ffn(*(torch.from_numpy(a).to(torch.bfloat16) for a in arrays),
                       top_k=2, capacity_factor=1.25)
    assert y.dtype == torch.bfloat16
    ry = np.asarray(ry, np.float32)
    scale = np.abs(ry).max(axis=-1, keepdims=True)
    assert (np.abs(y.float().numpy() - ry) <= 2e-2 * scale).all()


# (reduced overrides): the default dispatch, token chunks, dense training route
MODEL_CASES = {
    "dispatch": {},
    "chunked": dict(moe_chunk=8),
    "dense_train": dict(moe_dense_train=True),
    "low_capacity": dict(capacity_factor=0.5),
}


@pytest.mark.parametrize("arch", ["granite-moe-1b-a400m", "olmoe-1b-7b"])
@pytest.mark.parametrize("case", sorted(MODEL_CASES))
def test_moe_model_forward_matches_the_reference(arch, case):
    ref_model, params, model = both_models(arch, MODEL_CASES[case])
    tokens = np.random.default_rng(1).integers(0, model.cfg.vocab_size, (2, 24))
    want, raux = ref_model.forward(params, {"tokens": jnp.asarray(tokens, jnp.int32)})
    got, aux = model({"tokens": torch.from_numpy(tokens)})
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=5e-5, atol=5e-5)
    np.testing.assert_allclose(float(aux), float(raux), rtol=1e-6, atol=1e-7)
    if case == "dense_train":
        assert float(aux) == 0.0
    else:
        assert float(aux) > 0.0


def test_moe_layer_parameters_carry_over_and_a_missing_one_is_named():
    from repro_torch.convert import model_params_from_arrays
    ref_model, params, model = both_models("granite-moe-1b-a400m",
                                           dict(dtype="bfloat16"))
    state = model.state_dict()
    for name in ("router", "e_w1", "e_w3", "e_w2"):
        got = state[f"layers.{name}"]
        assert got.dtype == torch.bfloat16
        assert np.array_equal(got.view(torch.int16).numpy(),
                              np.asarray(params["layers"][name]).view(np.int16))
    arrays = jax.tree.map(np.asarray, params)
    del arrays["layers"]["e_w3"]
    with pytest.raises(ValueError, match="e_w3"):
        model_params_from_arrays(model.cfg, arrays, device="cpu")
