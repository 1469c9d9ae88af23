"""The port's slot engine (``repro_torch.serve.engine.ServeEngine``) held to
the reference's, on the CPU, and the serving CLI.

Both engines serve the same requests (prompts and budgets from a numpy
seed) over the same weights (the reference's, carried over by
``model_params_from_arrays``), greedy: the tokens must be equal, token for
token, and so must the engine steps.  Reduced configs in f32, whose decode
logits agree to 5e-5 (``test_torch_decode.py``); a greedy pick differs only
if two logits of a row lie within that of each other.

The reference's engine cases (``tests/test_serve.py``) run by name on the
port; its check that the decode graph compiles once is, here, that the
cache tensors keep their storage, shapes and dtypes across steps and
admissions and that ``decode_step`` sees one input shape.
"""

import numpy as np
import pytest
import torch

from repro.serve.engine import ServeEngine as RefServeEngine
from repro_torch.configs import ARCHITECTURES
from repro_torch.launch import serve as launch_serve
from repro_torch.models import Model
from repro_torch.serve import ServeEngine

from torch_parity import both_models

ENGINE_ARCHS = {
    "internlm2-1.8b": {},
    "hymba-1.5b": dict(sliding_window=8),
    "rwkv6-7b": {},
    "granite-moe-1b-a400m": {},
}


def _requests(vocab, n, seed):
    rng = np.random.default_rng(seed)
    return [(rng.integers(0, vocab, int(rng.integers(1, 12))).tolist(),
             int(rng.integers(2, 9))) for _ in range(n)]


@pytest.mark.parametrize("arch", sorted(ENGINE_ARCHS))
def test_engine_matches_the_reference_token_for_token(arch):
    ref_model, params, model = both_models(arch, ENGINE_ARCHS[arch])
    ref = RefServeEngine(ref_model, params, batch_slots=3, cache_len=32)
    eng = ServeEngine(model, batch_slots=3, cache_len=32)
    for prompt, budget in _requests(model.cfg.vocab_size, 7, seed=len(arch)):
        assert eng.submit(prompt, budget) == ref.submit(prompt, budget)
    want, got = ref.run(), eng.run()
    assert got == want
    assert eng.steps == ref.steps


def make_engine(arch="internlm2-1.8b", slots=3, cache_len=64):
    cfg = ARCHITECTURES[arch].reduced()
    model = Model(cfg, device="cpu").init(torch.Generator().manual_seed(0))
    return ServeEngine(model, batch_slots=slots, cache_len=cache_len)


def test_engine_serves_batched_requests():
    eng = make_engine()
    ids = [eng.submit([1, 2, 3], max_new_tokens=5) for _ in range(5)]
    out = eng.run()
    assert set(out) == set(ids)
    assert all(len(v) == 5 for v in out.values())
    v = eng.model.cfg.vocab_size
    assert all(0 <= t < v for toks in out.values() for t in toks)


def test_engine_continuous_batching_isolation():
    """A request admitted into a reused slot must match a fresh engine's
    output for the same prompt (no state leakage across requests)."""
    eng = make_engine(slots=1)
    eng.submit([5, 6, 7], max_new_tokens=4)
    eng.submit([9, 8], max_new_tokens=4)  # reuses slot 0 afterwards
    out = eng.run()
    fresh = make_engine(slots=1)
    fresh.submit([9, 8], max_new_tokens=4)
    expected = fresh.run()
    assert out[1] == expected[0]


def test_engine_ssm_arch_state_reset():
    eng = make_engine("rwkv6-7b", slots=2)
    a = eng.submit([3, 3, 3], max_new_tokens=3)
    out1 = eng.run()
    b = eng.submit([3, 3, 3], max_new_tokens=3)
    out2 = eng.run()
    assert out1[a] == out2[b]  # identical prompt -> identical greedy output


def test_engine_single_compiled_graph():
    """The counterpart of one compiled graph: every step sees one token
    shape and one cache layout, and the cache keeps its storage across
    steps, runs and admissions."""
    eng = make_engine("hymba-1.5b", slots=2)
    layout = {k: (v.data_ptr(), tuple(v.shape), v.dtype) for k, v in eng.cache.items()}
    seen = set()
    step = eng.model.decode_step

    def spy(cache, token):
        seen.add((tuple(token.shape), token.dtype,
                  tuple((k, v.data_ptr(), tuple(v.shape), v.dtype)
                        for k, v in sorted(cache.items()))))
        return step(cache, token)

    eng.model.decode_step = spy
    eng.submit([1], max_new_tokens=3)
    eng.run()
    n1 = len(seen)
    eng.submit([2, 3], max_new_tokens=3)
    eng.submit([4, 5, 6, 7], max_new_tokens=2)
    eng.run()
    assert len(seen) == n1 == 1
    assert {k: (v.data_ptr(), tuple(v.shape), v.dtype)
            for k, v in eng.cache.items()} == layout


def test_engine_sampling_is_seeded():
    """Temperature sampling draws on the host from the engine's seed: two
    engines with one seed give the same tokens."""
    outs = []
    for _ in range(2):
        eng = make_engine(slots=2)
        eng.greedy = False
        eng.rng = np.random.default_rng(7)
        eng.submit([1, 2], max_new_tokens=6)
        eng.submit([3], max_new_tokens=4)
        outs.append(eng.run())
    assert outs[0] == outs[1]
    assert all(0 <= t < 256 for toks in outs[0].values() for t in toks)


def test_launch_serve_cli_on_the_cpu(capsys):
    out = launch_serve.main(["--arch", "rwkv6-7b", "--reduced", "--device", "cpu",
                             "--requests", "3", "--slots", "2", "--max-new", "4"])
    assert sorted(out) == [0, 1, 2] and all(len(v) == 4 for v in out.values())
    assert "served 3/3 requests, 12 tokens" in capsys.readouterr().out
