"""``layers.decode_attention`` on a device mesh: each product on local
tensors (no DTensor rule asked for a view of sharded heads, which torch
2.11 lacks), equal to the plain function; and the plain function's bits
unchanged.

A gloo (2, 2) group of four CPU ranks (``torch_mesh_worker.decode``) runs
decode_attention on q and caches sharded four ways (batch, heads, cache
slots, both), and a prefill of 20 tokens into a 16-slot cache (its ring
rolls: ``layers.roll``, another rule 2.11 lacks) then four ``decode_step``
s of reduced internlm2-1.8b, olmoe-1b-7b and hymba-1.5b sharded by
``train/sharding.py`` with ``cache_pspecs``' cache; each is held to the
unsharded run within rtol 1e-5 (f32: where the slots are sharded the last
product's sum adds per rank, then over ranks).
"""

import multiprocessing
import os

import numpy as np
import pytest
import torch

import torch_mesh_worker as worker
from repro_torch.models import Model
from repro_torch.models.layers import NEG_INF, decode_attention, heads

JOIN_S = 240


@pytest.fixture(scope="module")
def mesh_run(tmp_path_factory):
    out_dir = str(tmp_path_factory.mktemp("decode_mesh"))
    ctx = multiprocessing.get_context("spawn")
    os.environ.setdefault("GLOO_SOCKET_IFNAME", "lo")
    store = os.path.join(out_dir, "store")
    procs = [ctx.Process(target=worker.decode, args=(r, 4, store, (2, 2), out_dir))
             for r in range(4)]
    for p in procs:
        p.start()
    for p in procs:
        p.join(JOIN_S)
    alive = [p for p in procs if p.is_alive()]
    for p in alive:
        p.kill()
    assert not alive, f"{len(alive)} ranks still running after {JOIN_S} s"
    assert all(p.exitcode == 0 for p in procs), [p.exitcode for p in procs]
    return dict(np.load(os.path.join(out_dir, "decode.npz")))


@pytest.mark.parametrize("window", [0, 5])
@pytest.mark.parametrize("placement", sorted(worker.DECODE_PLACEMENTS))
def test_decode_attention_on_a_mesh_equals_the_plain_function(mesh_run, placement, window):
    q, k, v, pos = (torch.from_numpy(a) for a in worker.decode_inputs())
    want = decode_attention(q, k, v, pos=pos, window=window).numpy()
    np.testing.assert_allclose(mesh_run[f"attn/{placement}/{window}"], want,
                               rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("arch", worker.DECODE_ARCHS)
def test_sharded_decode_steps_equal_the_unsharded_ones(mesh_run, arch):
    model = Model(worker.reduced(arch), device="cpu").init(torch.Generator().manual_seed(0))
    prompt, steps = worker.decode_tokens(model.cfg)
    lg, cache = model.prefill({"tokens": torch.from_numpy(prompt)}, cache_len=worker.CACHE_LEN)
    np.testing.assert_allclose(mesh_run[f"prefill/{arch}"], lg.numpy(), rtol=1e-5, atol=1e-5)
    for t, tok in enumerate(steps):
        lg, cache = model.decode_step(cache, torch.from_numpy(tok))
        np.testing.assert_allclose(mesh_run[f"logits/{arch}/{t}"], lg.numpy(),
                                   rtol=1e-5, atol=1e-5, err_msg=f"{arch} step {t}")


def _decode_attention_before(q, k_cache, v_cache, *, pos, window=0, scale=None):
    """decode_attention as it was before the mesh path, for plain tensors."""
    b, hq, d = q.shape
    hkv, s = k_cache.shape[1], k_cache.shape[2]
    scale = float(scale if scale is not None else 1.0 / (d ** 0.5))
    qg = heads(q.contiguous(), b, hkv, hq // hkv, d, dim=1).float()
    sc = torch.matmul(qg, k_cache.float().transpose(-1, -2)) * scale
    k_pos = torch.arange(s, device=q.device)
    pos = pos.to(torch.int64)
    mask = k_pos[None, :] <= pos[:, None]
    if window:
        mask = mask & (k_pos[None, :] > (pos - window)[:, None])
    sc = torch.where(mask[:, None, None, :], sc, NEG_INF)
    p = torch.softmax(sc, dim=-1).to(v_cache.dtype)
    o = torch.matmul(p.float(), v_cache.float())
    return o.reshape(b, hq, d).to(q.dtype)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("window", [0, 3])
def test_plain_decode_attention_keeps_its_bits(dtype, window):
    rng = np.random.default_rng(11)
    q = torch.from_numpy(rng.standard_normal((3, 6, 32)).astype(np.float32)).to(dtype)
    k = torch.from_numpy(rng.standard_normal((3, 2, 20, 32)).astype(np.float32)).to(dtype)
    v = torch.from_numpy(rng.standard_normal((3, 2, 20, 32)).astype(np.float32)).to(dtype)
    pos = torch.tensor([0, 9, 19], dtype=torch.int32)
    got = decode_attention(q, k, v, pos=pos, window=window, scale=0.2)
    want = _decode_attention_before(q, k, v, pos=pos, window=window, scale=0.2)
    assert torch.equal(got.view(torch.int16) if dtype == torch.bfloat16 else got.view(torch.int32),
                       want.view(torch.int16) if dtype == torch.bfloat16 else want.view(torch.int32))
