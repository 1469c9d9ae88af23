"""The port's guaranteed-error evaluator held to the reference's, on the CPU.

On a numpy block metric both evaluators must agree in every field of their
result and in every shard id they request, in the planned branch and in the
exact fallback.  With the eval slice's own metric, the summed NLL of a
reduced hymba over token shards, the port's model (the reference's weights
carried over) must draw the same pilot and final shards and land within
1e-5 of the reference's estimate.
"""

import dataclasses
import importlib.util
import pathlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.aqpeval import GuaranteedEvaluator as RefEvaluator
from repro.configs import get_config as ref_get_config
from repro.models import build_model as ref_build_model
from repro_torch.aqpeval import ApproxEvalResult, GuaranteedEvaluator
from repro_torch.configs import get_config
from repro_torch.convert import model_params_from_arrays
from repro_torch.models import Model

_EXAMPLE = pathlib.Path(__file__).resolve().parents[1] / "examples" / "torch_approx_eval.py"


def _example():
    spec = importlib.util.spec_from_file_location("torch_approx_eval", _EXAMPLE)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _recording(metric):
    """``metric`` plus the list of id arrays it was asked for."""
    seen = []

    def block_metric(ids):
        seen.append(np.asarray(ids).copy())
        return metric(ids)

    return block_metric, seen


def _numpy_metric(sums, counts):
    return lambda ids: (sums[ids], counts[ids])


# (n blocks, seed, sums maker, evaluate kwargs, expect exact)
def _planned_sums(rng, n):
    """A per-block mean near 3 over 80-120 elements: a feasible plan."""
    counts = rng.integers(80, 120, n).astype(float)
    return counts * rng.normal(3.0, 0.2, n), counts


def _heavy_tail_sums(rng, n):
    """Mostly zero with rare huge blocks: no positive lower bound on the
    mean, so the plan is infeasible and the evaluator falls back."""
    sums = np.zeros(n)
    sums[rng.choice(n, 3, replace=False)] = 1e6
    return sums, np.full(n, 100.0)


CASES = {
    "planned": (2000, 7, _planned_sums, dict(error=0.05, confidence=0.9,
                                             pilot_blocks=60), False),
    "planned_tight": (4000, 8, _planned_sums, dict(error=0.03, confidence=0.95,
                                                   pilot_blocks=150), False),
    "exact_fallback": (300, 9, _heavy_tail_sums, dict(error=0.05, confidence=0.9,
                                                      pilot_blocks=24), True),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_evaluator_matches_the_reference_on_a_numpy_metric(case):
    n, seed, make, kw, exact = CASES[case]
    sums, counts = make(np.random.default_rng(seed), n)
    ref_metric, ref_seen = _recording(_numpy_metric(sums, counts))
    port_metric, port_seen = _recording(_numpy_metric(sums, counts))
    want = RefEvaluator(n, ref_metric, seed=seed).evaluate(**kw)
    got = GuaranteedEvaluator(n, port_metric, seed=seed).evaluate(**kw)
    assert isinstance(got, ApproxEvalResult)
    assert dataclasses.asdict(got) == dataclasses.asdict(want)
    assert got.exact is exact
    assert got.blocks_saved_frac == want.blocks_saved_frac
    assert len(port_seen) == len(ref_seen) == 2
    for a, b in zip(port_seen, ref_seen):
        np.testing.assert_array_equal(a, b)
    if not exact:
        assert 0.0 < got.theta < 0.5 and got.final_blocks < n


def test_eval_slice_matches_the_reference_with_a_reduced_hymba():
    """The slice end to end on the CPU: 24 shards of 2 x 32 tokens, a
    reduced hymba (window 16, so it binds), the reference's weights in both
    packages, the reference's metric (``examples/approx_eval.py``) against
    the port's (``examples/torch_approx_eval.py``)."""
    arch, overrides = "hymba-1.5b", dict(sliding_window=16)
    ref_cfg = ref_get_config(arch).reduced(**overrides)
    ref_model = ref_build_model(ref_cfg)
    params = ref_model.init(jax.random.PRNGKey(0))
    cfg = get_config(arch).reduced(**overrides)
    model = Model(cfg, device="cpu")
    model.load_state_dict(model_params_from_arrays(
        cfg, jax.tree.map(np.asarray, params), device="cpu"))

    example = _example()
    n, bsz, seq = 24, 2, 32
    shards = example.eval_corpus(cfg.vocab_size, n, bsz, seq)
    assert shards.shape == (n, bsz, seq + 1)

    @jax.jit
    def ref_shard_loss(tokens):
        logits, _ = ref_model.forward(params, {"tokens": tokens[:, :-1]})
        lp = jax.nn.log_softmax(logits.astype(jnp.float32), -1)
        return -jnp.take_along_axis(lp, tokens[:, 1:, None], axis=-1).sum()

    def ref_block_metric(ids):
        sums = np.array([float(ref_shard_loss(jnp.asarray(shards[i]))) for i in ids])
        return sums, np.full(len(ids), bsz * seq, float)

    port_block_metric, calls = example.make_block_metric(model, shards)
    ref_metric, ref_seen = _recording(ref_block_metric)
    port_metric, port_seen = _recording(port_block_metric)
    kw = dict(error=0.05, confidence=0.9, pilot_blocks=8)
    want = RefEvaluator(n, ref_metric, seed=3).evaluate(**kw)
    got = GuaranteedEvaluator(n, port_metric, seed=3).evaluate(**kw)
    assert len(port_seen) == len(ref_seen)
    for a, b in zip(port_seen, ref_seen):
        np.testing.assert_array_equal(a, b)          # pilot, then final ids
    assert calls["shards"] == sum(len(a) for a in port_seen)
    assert got.exact == want.exact
    assert (got.pilot_blocks, got.final_blocks) == (want.pilot_blocks, want.final_blocks)
    assert got.estimate == pytest.approx(want.estimate, rel=1e-5)
    assert got.theta == pytest.approx(want.theta, rel=1e-4)
    # every shard's loss itself, port against reference
    ids = np.arange(4)
    np.testing.assert_allclose(port_block_metric(ids)[0], ref_block_metric(ids)[0],
                               rtol=1e-5)


def test_shard_loss_is_the_mean_nll_definition():
    """The port's shard metric: log_softmax in f32 over every padded vocab
    column, the NLL summed over tokens[:, 1:]."""
    example = _example()
    cfg = get_config("internlm2-1.8b").reduced()
    model = Model(cfg, device="cpu").init(torch.Generator().manual_seed(4))
    tokens = torch.from_numpy(example.eval_corpus(cfg.vocab_size, 1, 2, 12)[0])
    with torch.inference_mode():
        got = float(example.shard_loss(model, tokens))
        logits, _ = model({"tokens": tokens[:, :-1]})
    lp = torch.log_softmax(logits.double(), dim=-1).numpy()
    want = -sum(lp[b, t, int(tokens[b, t + 1])] for b in range(2) for t in range(12))
    assert got == pytest.approx(want, rel=1e-5)
