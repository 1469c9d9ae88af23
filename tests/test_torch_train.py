"""The port's training path (``repro_torch.train``, ``launch/train.py``)
against the reference's on the CPU, at reduced configs whose weights the
reference draws (``torch_parity.both_models``): one ``make_train_step`` step
of four families against the reference's jitted step (loss, every gradient,
parameters and moments after AdamW), microbatches and compression, the
optimizer's and compressor's arithmetic, the data pipeline and its
AQP-planned mixture, checkpoints across the two packages in both
directions, the elastic planner and watchdog, and the launcher."""

import dataclasses
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.launch import train as ref_launch
from repro.train import checkpoint as ref_ckpt
from repro.train import compression as ref_compression
from repro.train import data as ref_data
from repro.train import elastic as ref_elastic
from repro.train import optimizer as ref_opt
from repro.train import step as ref_step
from repro_torch.convert import _tree_to_arrays, train_state_to_arrays
from repro_torch.launch import train as launch
from repro_torch.train import checkpoint as ckpt
from repro_torch.train import compression, data, elastic, optimizer, step
from torch_parity import assert_tree_close, bind_train_state, both_models, both_train_states

jax.config.update("jax_default_matmul_precision", "highest")

# the reduced families, and hymba with a vocabulary off the 128 padding
FAMILIES = {
    "internlm2-1.8b": {},
    "hymba-1.5b": {"vocab_size": 250},
    "rwkv6-7b": {},
    "granite-moe-1b-a400m": {},
}
# eps 1e-3 keeps Adam's first steps Lipschitz in the gradient: at 1e-8 an
# element whose clipped gradient is within the f32 noise of zero moves by
# anything up to lr (g / (|g| + eps)), so parameters could not be compared;
# the arithmetic at the default eps is held to the reference's on given
# gradients in test_adamw_update_equals_the_reference
OPT = dict(lr=3e-3, warmup_steps=0, eps=1e-3)


def _batch(vocab, b=4, s=16, seed=3):
    toks = np.random.default_rng(seed).integers(0, vocab, (b, s + 1)).astype(np.int32)
    return {"tokens": toks[:, :-1], "labels": toks[:, 1:]}


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _port_grads(model, batch, vocab):
    logits, aux = model(batch)
    loss = step.cross_entropy(logits, batch["labels"], vocab) + 0.01 * aux
    names = [n for n, _ in model.named_parameters()]
    grads = torch.autograd.grad(loss, list(model.parameters()))
    return loss, {n: g.detach() for n, g in zip(names, grads)}


# -- one step of each family against the reference's jitted step ---------------

@pytest.mark.parametrize("arch", sorted(FAMILIES))
def test_one_train_step_matches_the_reference(arch):
    """f32, one step at lr 3e-3 with weight decay 0.1 on every leaf: the
    loss within rtol 1e-5; every gradient leaf within 1e-4 of its scale
    (flash and GLA through the port's backward, sums in other orders, GLA
    chunks of 64 against the reference's 32; measured up to 2.3e-6); the
    parameters within 1e-5 of their scale after AdamW (measured 1.5e-7) and
    the moments within 1e-4 of theirs (measured 4.8e-6)."""
    ref_model, ref_state, model, state = both_train_states(arch, FAMILIES[arch])
    vocab = model.cfg.vocab_size
    batch_np = _batch(vocab)
    batch = {k: torch.from_numpy(v) for k, v in batch_np.items()}
    jbatch = {k: jnp.asarray(v) for k, v in batch_np.items()}

    def ref_loss(params):
        logits, aux = ref_model.forward(params, jbatch)
        return ref_step.cross_entropy(logits, jbatch["labels"], vocab) + 0.01 * aux

    want_loss, want_grads = jax.value_and_grad(ref_loss)(ref_state.params)
    loss, grads = _port_grads(model, batch, vocab)
    np.testing.assert_allclose(float(loss.detach()), float(want_loss), rtol=1e-5)
    assert_tree_close(_tree_to_arrays(grads), _np(want_grads), 1e-4, "grads")

    new_ref, ref_metrics = jax.jit(ref_step.make_train_step(
        ref_model, ref_opt.AdamWConfig(**OPT)))(ref_state, jbatch)
    new, metrics = step.make_train_step(model, optimizer.AdamWConfig(**OPT))(state, batch)
    np.testing.assert_allclose(float(metrics["loss"]), float(ref_metrics["loss"]), rtol=1e-5)
    np.testing.assert_allclose(float(metrics["grad_norm"]), float(ref_metrics["grad_norm"]),
                               rtol=1e-5)
    assert float(metrics["lr"]) == float(ref_metrics["lr"])
    params, opt, _ = train_state_to_arrays(new)
    assert_tree_close(params, _np(new_ref.params), 1e-5, "params")
    assert_tree_close(opt["mu"], _np(new_ref.opt.mu), 1e-4, "mu")
    assert_tree_close(opt["nu"], _np(new_ref.opt.nu), 1e-4, "nu")
    assert int(opt["step"]) == int(new_ref.opt.step) == 1
    assert opt["step"].dtype == np.int32


def test_microbatched_steps_match_the_reference():
    """Three steps with microbatches=2 (the strided split, f32 gradient
    sums): losses within rtol 1e-5, the parameters within 1e-5 of their
    scale after each."""
    ref_model, ref_state, model, state = both_train_states("internlm2-1.8b", {})
    cfg = ref_opt.AdamWConfig(**OPT)
    ref_fn = jax.jit(ref_step.make_train_step(ref_model, cfg, microbatches=2))
    fn = step.make_train_step(model, optimizer.AdamWConfig(**OPT), microbatches=2)
    for i in range(3):
        b = _batch(model.cfg.vocab_size, seed=10 + i)
        ref_state, rm = ref_fn(ref_state, {k: jnp.asarray(v) for k, v in b.items()})
        state, m = fn(state, {k: torch.from_numpy(v) for k, v in b.items()})
        np.testing.assert_allclose(float(m["loss"]), float(rm["loss"]), rtol=1e-5)
        assert_tree_close(train_state_to_arrays(state)[0], _np(ref_state.params), 1e-5,
                           f"params after step {i}")


def test_compressed_step_matches_the_reference():
    """compress=True: int8 error feedback on every gradient leaf before
    AdamW.  The loss within rtol 1e-5 and the squared compression error
    within rtol 1e-3.  A gradient element on a rounding boundary of its
    leaf's int8 grid may take the neighbouring code (the gradients agree to
    ~1e-6 of their scale, not bitwise): at most 1 element in 1,000 a leaf,
    whose residual then differs by one quantization step (max |g| / 127);
    everywhere else the residual agrees to 1e-3 of a step and the parameters
    within 1e-5."""
    ref_model, ref_state, model, state = both_train_states("hymba-1.5b", FAMILIES["hymba-1.5b"],
                                               compress=True)
    vocab = model.cfg.vocab_size
    b = _batch(vocab)
    jb = {k: jnp.asarray(v) for k, v in b.items()}

    def ref_loss(params):
        logits, aux = ref_model.forward(params, jb)
        return ref_step.cross_entropy(logits, jb["labels"], vocab) + 0.01 * aux

    ref_grads = _np(jax.grad(ref_loss)(ref_state.params))
    ref_new, rm = jax.jit(ref_step.make_train_step(
        ref_model, ref_opt.AdamWConfig(**OPT), compress=True))(ref_state, jb)
    new, m = step.make_train_step(model, optimizer.AdamWConfig(**OPT), compress=True)(
        state, {k: torch.from_numpy(v) for k, v in b.items()})
    np.testing.assert_allclose(float(m["loss"]), float(rm["loss"]), rtol=1e-5)
    np.testing.assert_allclose(float(m["compression_err"]), float(rm["compression_err"]),
                               rtol=1e-3)
    params, _, residual = train_state_to_arrays(new)
    for (path, g), p, w, r, wr in zip(jax.tree_util.tree_flatten_with_path(ref_grads)[0],
                                      jax.tree.leaves(params), jax.tree.leaves(_np(ref_new.params)),
                                      jax.tree.leaves(residual),
                                      jax.tree.leaves(_np(ref_new.residual))):
        q_step = np.abs(g).max() / 127.0
        dres = np.abs(r - wr)
        flipped = dres > 1e-3 * q_step
        assert flipped.sum() <= max(1, g.size // 1000), jax.tree_util.keystr(path)
        assert np.all(dres <= 1.001 * q_step), jax.tree_util.keystr(path)
        assert np.all(np.abs(p - w)[~flipped] <= 1e-5), jax.tree_util.keystr(path)


def test_cross_entropy_masks_the_padded_vocab_as_the_reference():
    """Huge logits on padding columns change nothing once masked; values
    equal the reference's, and the gradient of the padding is zero."""
    rng = np.random.default_rng(0)
    logits = rng.standard_normal((2, 5, 16)).astype(np.float32)
    logits[..., 12:] = 50.0
    labels = rng.integers(0, 12, (2, 5)).astype(np.int32)
    t = torch.from_numpy(logits).requires_grad_()
    got = step.cross_entropy(t, torch.from_numpy(labels), 12)
    want = ref_step.cross_entropy(jnp.asarray(logits), jnp.asarray(labels), 12)
    np.testing.assert_allclose(float(got.detach()), float(want), rtol=1e-6)
    got.backward()
    assert torch.all(t.grad[..., 12:] == 0)
    wg = jax.grad(lambda x: ref_step.cross_entropy(x, jnp.asarray(labels), 12))(
        jnp.asarray(logits))
    np.testing.assert_allclose(t.grad.numpy(), np.asarray(wg), rtol=1e-6, atol=1e-8)


# -- optimizer and compression arithmetic ---------------------------------------

def test_lr_schedule_equals_the_reference():
    """The schedule's f32 arithmetic at every step from 0 past the end, for
    two configs: the reference's to 4 f32 ulps (XLA's cosine and torch's
    differ in the last bits, and the products carry it)."""
    for cfg in (dict(lr=1e-3, warmup_steps=10, total_steps=100),
                dict(lr=3e-3, warmup_steps=1, total_steps=7, min_lr_ratio=0.25)):
        for s in range(0, cfg["total_steps"] + 5):
            got = optimizer.lr_schedule(optimizer.AdamWConfig(**cfg),
                                        torch.tensor(s, dtype=torch.int32))
            want = ref_opt.lr_schedule(ref_opt.AdamWConfig(**cfg), jnp.int32(s))
            assert got.dtype == torch.float32
            np.testing.assert_allclose(float(got), float(want), rtol=2 ** -21, atol=0)


def test_adamw_update_equals_the_reference():
    """adamw_update at the default eps 1e-8 on the same parameters (f32 and
    bf16), gradients and moments, two steps: the f32 parameters and the
    moments within 2 f32 ulps of the reference's, bf16 parameters within
    one bf16 step (the f32 value they round from may straddle a tie)."""
    rng = np.random.default_rng(4)
    mk = lambda *s: rng.standard_normal(s).astype(np.float32)
    p = {"a": mk(5, 3), "b": mk(7)}
    g = [{"a": mk(5, 3) * 3, "b": mk(7) * 1e-6}, {"a": mk(5, 3), "b": mk(7)}]
    cfg = dict(lr=1e-2, warmup_steps=1, total_steps=10)
    for dt, jdt in ((torch.float32, jnp.float32), (torch.bfloat16, jnp.bfloat16)):
        # each package its own copy: adamw_update writes tp in place, and
        # torch.from_numpy(v) and jnp.asarray(v) may both alias v
        tp = {k: torch.from_numpy(v.copy()).to(dt) for k, v in p.items()}
        jp = {k: jnp.asarray(v.copy()).astype(jdt) for k, v in p.items()}
        ts, js = optimizer.init_opt_state(tp), ref_opt.init_opt_state(jp)
        for gs in g:
            tp, ts, tm = optimizer.adamw_update(optimizer.AdamWConfig(**cfg), tp,
                                                {k: torch.from_numpy(v) for k, v in gs.items()}, ts)
            jp, js, jm = ref_opt.adamw_update(ref_opt.AdamWConfig(**cfg), jp,
                                              {k: jnp.asarray(v) for k, v in gs.items()}, js)
            assert float(tm["lr"]) == float(jm["lr"])
            for k in p:
                for a, b, rel in ((tp[k].float().numpy(), np.asarray(jp[k], np.float32),
                                   2 ** -22 if dt == torch.float32 else 2 ** -7),
                                  (ts.mu[k].numpy(), np.asarray(js.mu[k]), 2 ** -22),
                                  (ts.nu[k].numpy(), np.asarray(js.nu[k]), 2 ** -22)):
                    np.testing.assert_allclose(a, b, rtol=rel, atol=1e-30)


def test_global_norm_and_adamw_on_a_quadratic():
    """global_norm equals the reference's; AdamW drives a quadratic to 0 in
    150 steps, as the reference's test asks."""
    rng = np.random.default_rng(2)
    tree = {"a": rng.standard_normal((3, 4)).astype(np.float32),
            "b": rng.standard_normal(7).astype(np.float32)}
    np.testing.assert_allclose(
        float(optimizer.global_norm({k: torch.from_numpy(v) for k, v in tree.items()})),
        float(ref_opt.global_norm({k: jnp.asarray(v) for k, v in tree.items()})), rtol=1e-6)
    cfg = optimizer.AdamWConfig(lr=0.05, weight_decay=0.0, warmup_steps=0, total_steps=200,
                                min_lr_ratio=1.0)
    params = {"w": torch.tensor([3.0, -2.0, 1.0])}
    state = optimizer.init_opt_state(params)
    for _ in range(150):
        params, state, _ = optimizer.adamw_update(cfg, params, {"w": 2 * params["w"]}, state)
    assert float(params["w"].abs().max()) < 0.1
    assert state.step.dtype == torch.int32 and int(state.step) == 150


def test_quantize_and_compress_tree_equal_the_reference():
    """Symmetric int8 codes and scales bitwise the reference's (round half
    to even on both sides); compress_tree's compressed gradients, residuals
    and error over two error-feedback steps."""
    rng = np.random.default_rng(0)
    x = rng.normal(0, 3, 1000).astype(np.float32)
    q, s = compression.quantize(torch.from_numpy(x))
    rq, rs = ref_compression.quantize(jnp.asarray(x))
    assert np.array_equal(q.numpy(), np.asarray(rq)) and float(s) == float(rs)
    zq, zs = compression.quantize(torch.zeros(4))
    assert float(zs) == 1.0 and not zq.any()
    grads = {"a": rng.normal(0, 1, (8, 3)).astype(np.float32),
             "b": rng.normal(0, 1e-3, 5).astype(np.float32)}
    res = {k: np.zeros_like(v) for k, v in grads.items()}
    rres = dict(res)
    for _ in range(2):
        g_hat, res_t, err = compression.compress_tree(
            {k: torch.from_numpy(v) for k, v in grads.items()},
            {k: torch.from_numpy(v) for k, v in res.items()})
        rg, rres, rerr = ref_compression.compress_tree(
            {k: jnp.asarray(v) for k, v in grads.items()},
            {k: jnp.asarray(v) for k, v in rres.items()})
        res = {k: v.numpy() for k, v in res_t.items()}
        for k in grads:
            np.testing.assert_array_equal(g_hat[k].numpy(), np.asarray(rg[k]))
            np.testing.assert_array_equal(res[k], np.asarray(rres[k]))
        np.testing.assert_allclose(float(err), float(rerr), rtol=1e-6)


# -- the data pipeline and the AQP-planned mixture --------------------------------

def test_token_pipeline_batches_are_the_references_and_resume():
    """Byte-equal batches for several steps and domain mixes; a pipeline
    resumed at step 3 from its JSON state gives step 3's batch."""
    for domains in (None, {"books": 0.2, "code": 0.3, "web": 0.5}):
        p = data.TokenPipeline(1000, batch=4, seq=8, seed=5, domains=domains)
        r = ref_data.TokenPipeline(1000, batch=4, seq=8, seed=5, domains=domains)
        for _ in range(5):
            a, b = p.next_batch(), r.next_batch()
            for k in ("tokens", "labels"):
                assert a[k].dtype == b[k].dtype and a[k].tobytes() == b[k].tobytes()
        assert p.state.to_json() == r.state.to_json()
    p = data.TokenPipeline(1000, batch=4, seq=8, seed=5)
    batches = [p.next_batch() for _ in range(5)]
    p2 = data.TokenPipeline(1000, batch=4, seq=8, seed=5)
    p2.state = data.DataState.from_json({"seed": 5, "step": 3, "cursors": {"default": 0}})
    np.testing.assert_array_equal(p2.next_batch()["tokens"], batches[3]["tokens"])


@pytest.mark.parametrize("seed", [0, 1])
def test_plan_mixture_weights_equals_the_reference(seed):
    """The metadata table (same columns, bit for bit, on the port's device)
    and the planned mixture: the same weights, fallback and scanned bytes as
    the reference's PilotDB on the same seed."""
    counts = {"web": 2000, "code": 1000, "books": 1000}
    meta = data.make_domain_metadata(counts, block_rows=64, seed=seed, device="cpu")
    ref_meta = ref_data.make_domain_metadata(counts, block_rows=64, seed=seed)
    for c in ("domain", "quality", "tokens"):
        np.testing.assert_array_equal(meta.columns[c].numpy(), np.asarray(ref_meta.columns[c]))
    w, report = data.plan_mixture_weights(meta, 3, error=0.1, confidence=0.9, seed=seed)
    rw, rreport = ref_data.plan_mixture_weights(ref_meta, 3, error=0.1, confidence=0.9,
                                                seed=seed)
    assert set(w) == set(rw) == {0, 1, 2}
    for g in w:
        np.testing.assert_allclose(w[g], rw[g], rtol=1e-9)
    assert w[2] > w[0]
    assert report.fallback == rreport.fallback is None
    assert (report.pilot_scanned_bytes, report.final_scanned_bytes, report.exact_scanned_bytes) \
        == (rreport.pilot_scanned_bytes, rreport.final_scanned_bytes,
            rreport.exact_scanned_bytes)


# -- checkpoints across the two packages ------------------------------------------

def _ref_tree(dtype, seed=0):
    rng = np.random.default_rng(seed)
    arr = lambda *s: jnp.asarray(rng.standard_normal(s).astype(np.float32)).astype(dtype)
    return {"w": arr(3, 4), "layers": {"b": arr(2, 5), "a": arr(2, 2, 3)},
            "step": jnp.int32(7)}


def _port_tree(tree):
    """The port's tensors of a reference tree: bf16 by its bits; the
    ``layers`` subtree keyed by state-dict name."""
    def t(a):
        a = np.asarray(a)
        if a.dtype == jnp.bfloat16:
            return torch.from_numpy(a.view(np.int16).copy()).view(torch.bfloat16)
        return torch.from_numpy(a.copy())
    out = {k: t(v) for k, v in tree.items() if k != "layers"}
    out.update({f"layers.{k}": t(v) for k, v in tree["layers"].items()})
    return out


@pytest.mark.parametrize("dtype", [jnp.float32, jnp.bfloat16])
def test_checkpoint_written_by_the_reference_restores_in_the_port(tmp_path, dtype):
    """The port reads the reference's layout: names, manifest and .npy
    payloads (bf16 by its raw 2 bytes), into its own tensors in place."""
    tree = _ref_tree(dtype)
    ref_ckpt.save(str(tmp_path), 5, tree, extra={"step": 5, "data_step": 9})
    target = {k: torch.zeros_like(v) for k, v in _port_tree(tree).items()}
    restored, extra = ckpt.restore(str(tmp_path), 5, target)
    assert restored is target and extra == {"step": 5, "data_step": 9}
    for k, v in _port_tree(tree).items():
        assert restored[k].dtype == v.dtype and torch.equal(restored[k], v), k


@pytest.mark.parametrize("dtype", [jnp.float32, jnp.bfloat16])
def test_checkpoint_written_by_the_port_is_the_references_layout(tmp_path, dtype):
    """The port writes the reference's manifest fields and leaf names, and
    .npy files byte for byte the reference's.  f32 restores in the
    reference; the reference's restore cannot place its own bf16 leaves
    (numpy loads them as void V2, which jax.device_put refuses), and fails
    the same way on the port's."""
    tree = _ref_tree(dtype)
    ref_dir, port_dir = str(tmp_path / "ref"), str(tmp_path / "port")
    ref_ckpt.save(ref_dir, 3, tree)
    ckpt.save(port_dir, 3, _port_tree(tree))
    a, b = (os.path.join(d, "step_00000003") for d in (ref_dir, port_dir))
    ma, mb = (json.load(open(os.path.join(d, "manifest.json"))) for d in (a, b))
    assert ma["leaves"] == mb["leaves"] and ma.keys() == mb.keys()
    assert mb["process_count"] == 1 and mb["device_count"] == torch.cuda.device_count()
    for leaf in ma["leaves"]:
        with open(os.path.join(a, leaf["name"] + ".npy"), "rb") as fa, \
                open(os.path.join(b, leaf["name"] + ".npy"), "rb") as fb:
            assert fa.read() == fb.read(), leaf["name"]
    if dtype == jnp.float32:
        restored, _ = ref_ckpt.restore(port_dir, 3, tree)
        for x, y in zip(jax.tree.leaves(restored), jax.tree.leaves(tree)):
            assert np.array_equal(np.asarray(x), np.asarray(y))
    else:
        for d in (ref_dir, port_dir):
            with pytest.raises(TypeError, match="V2"):
                ref_ckpt.restore(d, 3, tree)


def test_train_state_checkpoints_cross_both_ways(tmp_path):
    """A reference TrainState's checkpoint (params, step, moments, residual)
    restores into the port's state and the port's back into the reference's
    structure; gc keeps the last, shape mismatches raise, latest_step
    finds the newest."""
    ref_model, ref_state, model, state = both_train_states("internlm2-1.8b", {}, compress=True)
    ref_state = ref_state._replace(opt=ref_state.opt._replace(step=jnp.int32(4)),
                                   residual=jax.tree.map(lambda p: p + 0.5,
                                                         ref_state.residual))
    names = ref_ckpt._flatten(ref_state)[1]
    assert [n for n, _ in ckpt._flatten(state)] == names
    ref_ckpt.save(str(tmp_path), 4, ref_state)
    _, _, model2, state2 = both_train_states("internlm2-1.8b", {}, compress=True, seed=9)
    ckpt.restore(str(tmp_path), 4, state2)
    want_p, want_opt, want_r = (_np(ref_state.params), _np(ref_state.opt), _np(ref_state.residual))
    got_p, got_opt, got_r = train_state_to_arrays(state2)
    for g, w in zip(jax.tree.leaves(got_p) + jax.tree.leaves(got_r),
                    jax.tree.leaves(want_p) + jax.tree.leaves(want_r)):
        assert np.array_equal(g, w)
    assert int(got_opt["step"]) == 4
    assert all(p is q for p, q in zip(state2.params.values(), model2.parameters()))
    # back: the port writes, the reference restores (f32)
    ckpt.save(str(tmp_path / "back"), 6, state2, keep=2)
    back, _ = ref_ckpt.restore(str(tmp_path / "back"), 6, ref_state)
    for x, y in zip(jax.tree.leaves(back), jax.tree.leaves(ref_state)):
        assert np.array_equal(np.asarray(x), np.asarray(y))
    for s in (7, 8, 9):
        ckpt.save(str(tmp_path / "back"), s, {"w": torch.ones(2)}, keep=2)
    assert sorted(os.listdir(tmp_path / "back")) == ["step_00000008", "step_00000009"]
    assert ckpt.latest_step(str(tmp_path / "back")) == 9
    assert ckpt.latest_step(str(tmp_path / "none")) is None
    with pytest.raises(ValueError, match="shape"):
        ckpt.restore(str(tmp_path / "back"), 9, {"w": torch.ones(3)})
    with pytest.raises(KeyError):
        ckpt.restore(str(tmp_path / "back"), 9, {"v": torch.ones(2)})


def test_emergency_saver_flushes_on_sigterm(tmp_path):
    import signal
    saver = ckpt.EmergencySaver(str(tmp_path))
    try:
        assert not saver.maybe_save(1, {"w": torch.ones(2)})
        os.kill(os.getpid(), signal.SIGTERM)
        assert saver.maybe_save(2, {"w": torch.ones(2)})
    finally:
        saver.close()
    assert ckpt.latest_step(str(tmp_path)) == 2
    extra = json.load(open(tmp_path / "step_00000002" / "manifest.json"))["extra"]
    assert extra == {"emergency": True}


# -- the elastic planner and the watchdog ---------------------------------------

@pytest.mark.parametrize("n,kw", [(512, dict(tp=16, per_replica_batch=8, prefer_pods=True)),
                                  (496, dict(tp=16, per_replica_batch=8)),
                                  (64, dict(tp=8)), (300, dict(prefer_pods=True))])
def test_plan_mesh_matches_the_reference(n, kw):
    assert dataclasses.asdict(elastic.plan_mesh(n, **kw)) == \
        dataclasses.asdict(ref_elastic.plan_mesh(n, **kw))
    with pytest.raises(ValueError):
        elastic.plan_mesh(8, tp=16)


def test_straggler_watchdog_matches_the_reference():
    times = [1.0] * 6 + [5.0, 1.1, 5.0, 5.0, 0.9, 4.0]
    w, r = elastic.StragglerWatchdog(threshold=2.0, warmup=2), \
        ref_elastic.StragglerWatchdog(threshold=2.0, warmup=2)
    for dt in times:
        assert w.observe(dt) == r.observe(dt)
        assert w.should_remesh == r.should_remesh
    assert w.slow_steps == r.slow_steps and w.ewma == pytest.approx(r.ewma, rel=1e-12)
    assert w.should_remesh


# -- the launcher -----------------------------------------------------------------

def test_launcher_matches_the_reference_launcher(monkeypatch, capsys):
    """launch.train.main against repro.launch.train.main with the same
    flags, the port starting from the reference's initial weights (the two
    packages draw different numbers from one seed): the AQP-planned mixture
    line equal, losses within rtol 1e-5, the approximate eval run."""
    flags = ["--reduced", "--steps", "3", "--batch", "4", "--seq", "16",
             "--aqp-mixture", "--approx-eval", "--seed", "2"]
    want = ref_launch.main(flags)
    ref_out = capsys.readouterr().out

    def init_from_reference(model, generator, *, compress=False):
        ref_model, _, _ = both_models("internlm2-1.8b", {}, seed=0)
        params = ref_model.init(jax.random.PRNGKey(2))
        ref_state = ref_step.TrainState(params, ref_opt.init_opt_state(params), None)
        return bind_train_state(model, ref_state)

    monkeypatch.setattr(launch, "init_train_state", init_from_reference)
    got = launch.main(flags + ["--device", "cpu"])
    out = capsys.readouterr().out
    np.testing.assert_allclose(got, want, rtol=1e-5)
    mixture = [l for l in ref_out.splitlines() if l.startswith("[aqp-mixture]")]
    assert mixture and mixture[0] in out
    assert "[approx-eval] loss≈" in out and "final loss" in out


def test_launcher_resumes_from_its_checkpoint(tmp_path, capsys):
    """--ckpt-dir / --ckpt-every / --resume: a run of 4 steps checkpointed
    every 2, its step-4 checkpoint removed (as if it died after step 3),
    resumed from step 2 in a fresh model: the uninterrupted run's last two
    losses bitwise (same data step, same state)."""
    import shutil
    base = ["--reduced", "--device", "cpu", "--batch", "2", "--seq", "16", "--seed", "4",
            "--steps", "4"]
    d = str(tmp_path / "ck")
    full = launch.main(base + ["--ckpt-dir", d, "--ckpt-every", "2"])
    shutil.rmtree(os.path.join(d, "step_00000004"))
    resumed = launch.main(base + ["--ckpt-dir", d, "--resume", "--ckpt-every", "100"])
    assert "[resume] from step 2" in capsys.readouterr().out
    assert resumed == full[2:]
