"""Expert parallelism of the port's MoE FFN (``repro_torch.models.moe`` on a
device mesh) held to the reference's ``models/moe.py``, on the CPU: gloo
groups of 2 and 4 ranks (``tests/torch_moe_ep_worker.py``) on (1, 2), (2,
1), (2, 2) and (1, 4) meshes, reduced olmoe's layer in f32 (d_model 64, 4
experts of 128, top-2), the tokens and weights placed as
``train/sharding.py`` places a layer's.

Both sides get the same numpy inputs.  Outputs are held at 1e-5 and the aux
loss at 1e-6 of the reference's, as ``test_torch_moe.py`` holds the plain
route; the gradients of x, the router and each expert (the reference's by
``jax.grad`` of the same loss) at 1e-5 of each element and of the leaf's
largest magnitude (the ranks' partial sums add in another order).  With the
capacity cut, the dropped (token, slot) pairs are the reference's and lie
on more than one data rank's rows.  A dispatch hook on every rank shows its
expert products run over its own E / M experts and C / P capacity rows.
"""

import json
import math
import multiprocessing
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest

import torch_moe_ep_worker as worker
from repro.models import moe as ref_moe

MESHES = [(1, 2), (2, 1), (2, 2), (1, 4)]
JOIN_S = 240


def _tag(shape):
    return "x".join(map(str, shape))


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """Every mesh's ranks, all groups at once."""
    out = str(tmp_path_factory.mktemp("moe_ep"))
    ctx = multiprocessing.get_context("spawn")
    os.environ.setdefault("GLOO_SOCKET_IFNAME", "lo")
    procs = []
    for shape in MESHES:
        world = shape[0] * shape[1]
        store = os.path.join(out, "store_" + _tag(shape))
        procs += [ctx.Process(target=worker.run, args=(r, world, store, shape, out))
                  for r in range(world)]
    for p in procs:
        p.start()
    for p in procs:
        p.join(JOIN_S)
    alive = [p for p in procs if p.is_alive()]
    for p in alive:
        p.kill()
    assert not alive, f"{len(alive)} ranks still running after {JOIN_S} s"
    assert all(p.exitcode == 0 for p in procs), [p.exitcode for p in procs]
    return out


def _reference(case):
    """(y, aux or None, {grad_x, grad_router, grad_w1, grad_w3, grad_w2})."""
    _, route, cf, mlp = worker.CASES[case]
    *arrays, cot = (jnp.asarray(a) for a in worker.inputs(case))

    def loss(x, router, w1, w3, w2):
        if route == "moe_ffn":
            y, aux = ref_moe.moe_ffn(x, router, w1, w3, w2, top_k=worker.K,
                                     capacity_factor=cf, mlp_kind=mlp)
            return jnp.sum(y * cot) + worker.AUX_WEIGHT * aux, (y, aux)
        y = ref_moe.moe_ffn_dense(x, router, w1, w3, w2, top_k=worker.K, mlp_kind=mlp)
        return jnp.sum(y * cot), (y, None)

    grads, (y, aux) = jax.grad(loss, argnums=(0, 1, 2, 3, 4), has_aux=True)(*arrays)
    names = ("grad_x", "grad_router", "grad_w1", "grad_w3", "grad_w2")
    return (np.asarray(y), None if aux is None else float(aux),
            {n: np.asarray(g) for n, g in zip(names, grads)})


@pytest.fixture(scope="module")
def reference():
    return {case: _reference(case) for case in worker.CASES}


@pytest.mark.parametrize("case", list(worker.CASES))
@pytest.mark.parametrize("shape", MESHES, ids=_tag)
def test_expert_parallel_matches_the_reference(runs, reference, shape, case):
    got = np.load(os.path.join(runs, f"{_tag(shape)}_{case}.npz"))
    y, aux, grads = reference[case]
    np.testing.assert_allclose(got["y"], y, rtol=1e-5, atol=1e-5)
    if aux is not None:
        np.testing.assert_allclose(float(got["aux"]), aux, rtol=1e-6)
    for n, want in grads.items():
        np.testing.assert_allclose(got[n], want, rtol=1e-5,
                                   atol=1e-5 * float(np.abs(want).max()), err_msg=n)


def _dropped(y, experts):
    """The (token, slot) pairs whose expert wrote nothing into its own
    columns of y (the "drops" case's experts write disjoint columns)."""
    block = worker.D // worker.E
    return {(t, j) for t in range(y.shape[0]) for j in range(worker.K)
            if not np.any(y[t, experts[t, j] * block:(experts[t, j] + 1) * block])}


@pytest.mark.parametrize("shape", MESHES, ids=_tag)
def test_dropped_pairs_are_the_references(runs, reference, shape):
    import torch

    from repro_torch.models import moe

    x, router, *_ = worker.inputs("drops")
    _, _, experts = moe._route(torch.from_numpy(x), torch.from_numpy(router), worker.K)
    experts = experts.numpy()
    got = _dropped(np.load(os.path.join(runs, f"{_tag(shape)}_drops.npz"))["y"], experts)
    want = _dropped(reference["drops"][0], experts)
    assert got == want
    # capacity 12 an expert for 96 pairs: half or more drop, not all, and
    # the dropped pairs' tokens lie on both halves of the rows
    t = x.shape[0]
    assert t * worker.K // 2 <= len(want) < t * worker.K
    assert {tok * 2 // t for tok, _ in want} == {0, 1}


@pytest.mark.parametrize("shape", MESHES, ids=_tag)
def test_each_rank_multiplies_only_its_own_experts_and_rows(runs, shape):
    """Per rank, forward: one routing product over its own rows, and for
    ``moe_ffn`` three expert products of (E / M) batches of C / P capacity
    rows; for ``moe_ffn_dense`` exactly the FLOPs of E / M experts on its
    data rank's rows, beside the routing and the combine.  The backward's
    expert products keep the batch E / M."""
    p_data, m = shape
    e_m = worker.E // m
    flops = lambda shapes: 2 * math.prod(shapes[0]) * shapes[1][-1]
    for rank in range(p_data * m):
        with open(os.path.join(runs, f"{_tag(shape)}_products_{rank}.json")) as f:
            ran = json.load(f)
        for case, (t, route, cf, _) in worker.CASES.items():
            fwd, bwd = ran[case]["forward"], ran[case]["backward"]
            p = p_data if t % p_data == 0 else 1
            t_d = t // p
            t_r = t_d // (m if t_d % m == 0 else 1)
            assert fwd[0] == [[t_r, worker.D], [worker.D, worker.E]], (case, rank, fwd[0])
            if route == "moe_ffn":
                c = max(int(t * worker.K * cf / worker.E), worker.K)
                cap_p = -(-c // p)
                assert [s[0][:2] for s in fwd[1:]] == [[e_m, cap_p]] * 3, (case, rank, fwd)
                assert all(len(a) == 3 and a[0] == e_m for s in bwd[:-2] for a in s), (case, bwd)
            else:
                expert = 3 * 2 * e_m * t_d * worker.D * worker.F
                combine = 2 * worker.E * t_r * worker.D
                assert sum(flops(s) for s in fwd[1:]) == expert + combine, (case, rank, fwd)
