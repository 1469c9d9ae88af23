"""The reference's last public helpers in the port, each against the
reference on the CPU from seeded numpy inputs; then the port's flash and
GLA plain versions against the two independent oracles.

- ``BlockTable.column_names`` / ``to_numpy`` / ``with_valid`` /
  ``with_columns``: bitwise (``src/repro/engine/table.py``);
- ``engine.ops.group_ids`` / ``grouped_counts``: bitwise (integers; counts
  below 2^24 are exact in f32), and ``grouped_counts`` bitwise the eager
  executor's count row, where the reference's eager executor calls it
  (``src/repro/engine/executor.py:476``);
- ``attention_ref``: rtol 1e-5, atol 1e-6 (both f32 dense softmax);
- ``gla_recurrent_ref`` with and without ``initial_state``: rtol 1e-5,
  atol 1e-5 (the same f32 steps in the same order);
- ``models.build_model``: the reference's weights carried over, the
  forward within the 2e-5 of ``test_torch_models.py``;
- ``core.quickr.RowPilot`` and its statistics: bitwise (f64 numpy).

The port's ``flash_attention_ref`` (batched, GQA by index) against
``attention_ref`` head by head: rtol 1e-5, atol 1e-6.  Its chunked GLA
(``gla_chunked_ref``, and ``gla_chunked`` on the CPU) against
``gla_recurrent_ref``: rtol 1e-4, atol 1e-4, on decays in [-8, 0] that the
chunked form does not clamp (f32 sums in another order; the reference holds
its chunked kernel to its recurrence at 3e-3).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.core.quickr as ref_quickr
import repro.engine.executor as ref_executor
import repro.engine.logical as ref_L
import repro.engine.ops as ref_ops
from repro.engine.datagen import tpch_catalog as ref_tpch_catalog
from repro.kernels.flash_attn.ref import attention_ref as ref_attention_ref
from repro.kernels.gla_chunk.ref import gla_recurrent_ref as ref_gla_recurrent_ref
import repro_torch.core.quickr as quickr
import repro_torch.engine.logical as L
from repro_torch.engine import ops
from repro_torch.engine.datagen import tpch_catalog
from repro_torch.engine.executor import Executor
from repro_torch.kernels.flash_attn import attention_ref, flash_attention_ref
from repro_torch.kernels.gla_chunk import gla_chunked, gla_chunked_ref, gla_recurrent_ref
from repro_torch.models import Model, build_model

ROWS, BLOCK_ROWS = 20_000, 64


@pytest.fixture(scope="module")
def tables():
    return (tpch_catalog(ROWS, BLOCK_ROWS, seed=4, device="cpu")["lineitem"],
            ref_tpch_catalog(ROWS, BLOCK_ROWS, seed=4)["lineitem"])


def _masked(n, seed):
    return np.random.default_rng(seed).random(n) < 0.7


# -- BlockTable ------------------------------------------------------------------

def test_column_names_equal_the_references(tables):
    port, ref = tables
    assert port.column_names == ref.column_names


def test_to_numpy_is_bitwise_the_references(tables):
    port, ref = tables
    mask = _masked(port.padded_rows, 1)
    got = port.with_valid(torch.from_numpy(mask)).to_numpy()
    want = ref.with_valid(jnp.asarray(mask)).to_numpy()
    assert list(got) == list(want)
    for c in want:
        assert got[c].dtype == want[c].dtype, c
        np.testing.assert_array_equal(got[c].view(np.uint8), want[c].view(np.uint8))


def test_with_valid_and_with_columns_replace_only_their_field(tables):
    port, ref = tables
    mask = _masked(port.padded_rows, 2)
    pv = port.with_valid(torch.from_numpy(mask))
    rv = ref.with_valid(jnp.asarray(mask))
    assert pv is not port and pv.columns is port.columns
    assert pv.block_id is port.block_id and pv.num_rows == port.num_rows
    np.testing.assert_array_equal(pv.valid.numpy(), np.asarray(rv.valid))
    cols = {"l_tax": port.columns["l_tax"] * 2}
    pc = port.with_columns(cols)
    rc = ref.with_columns({"l_tax": ref.columns["l_tax"] * 2})
    assert pc.column_names == rc.column_names == ["l_tax"]
    assert pc.valid is port.valid
    np.testing.assert_array_equal(pc.to_numpy()["l_tax"], rc.to_numpy()["l_tax"])


# -- group_ids / grouped_counts --------------------------------------------------

@pytest.mark.parametrize("group_by,max_groups", [(None, 1), ("l_returnflag", 3),
                                                 ("l_returnflag", 2), ("l_shipdate", 64)])
def test_group_ids_and_counts_are_bitwise_the_references(tables, group_by, max_groups):
    port, ref = tables
    mask = _masked(port.padded_rows, 3)
    port, ref = port.with_valid(torch.from_numpy(mask)), ref.with_valid(jnp.asarray(mask))
    gid = ops.group_ids(port, group_by, max_groups)
    assert gid.dtype == torch.int32
    np.testing.assert_array_equal(gid.numpy(), np.asarray(ref_ops.group_ids(ref, group_by, max_groups)))
    got = ops.grouped_counts(port, group_by, max_groups).numpy()
    want = np.asarray(ref_ops.grouped_counts(ref, group_by, max_groups))
    assert got.dtype == want.dtype == np.float32
    np.testing.assert_array_equal(got.view(np.int32), want.view(np.int32))


@pytest.mark.parametrize("group_by,max_groups", [(None, 1), ("l_returnflag", 3)])
def test_grouped_counts_is_the_eager_executors_count_row(group_by, max_groups):
    from repro_torch.engine.expr import Col
    cat = tpch_catalog(ROWS, BLOCK_ROWS, seed=4, device="cpu")
    ref_cat = ref_tpch_catalog(ROWS, BLOCK_ROWS, seed=4)

    def plan(L_, Col_):
        return L_.Aggregate(child=L_.Filter(L_.Scan("lineitem"), Col_("l_discount") > 0.04),
                            aggs=(L_.AggSpec("sum", Col_("l_quantity"), "q"),),
                            group_by=group_by, max_groups=max_groups)
    import repro.engine.expr as ref_expr
    res = Executor(cat, device="cpu", use_compiled=False).execute(plan(L, Col))
    ref_res = ref_executor.Executor(ref_cat, use_compiled=False).execute(plan(ref_L, ref_expr.Col))
    filtered = ops.filter_table(cat["lineitem"], Col("l_discount") > 0.04)
    counts = ops.grouped_counts(filtered, group_by, max_groups).double().numpy()
    np.testing.assert_array_equal(counts.view(np.int64), res.group_counts.view(np.int64))
    np.testing.assert_array_equal(counts.view(np.int64),
                                  np.asarray(ref_res.group_counts, np.float64).view(np.int64))


# -- attention_ref, gla_recurrent_ref ----------------------------------------------

def _normal(rng, shape):
    return rng.standard_normal(shape).astype(np.float32)


@pytest.mark.parametrize("sq,skv,causal,kv_len", [(7, 7, True, None), (5, 9, False, None),
                                                  (6, 10, False, 4), (8, 8, True, 5),
                                                  (1, 12, False, 12)])
def test_attention_ref_matches_the_references(sq, skv, causal, kv_len):
    rng = np.random.default_rng(sq * 100 + skv)
    q, k, v = _normal(rng, (sq, 16)), _normal(rng, (skv, 16)), _normal(rng, (skv, 16))
    got = attention_ref(torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v),
                        scale=0.25, causal=causal, kv_len=kv_len).numpy()
    want = np.asarray(ref_attention_ref(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                                        scale=0.25, causal=causal, kv_len=kv_len))
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6)


def test_attention_ref_returns_the_input_dtype():
    rng = np.random.default_rng(0)
    q, k, v = (torch.from_numpy(_normal(rng, (4, 8))).to(torch.bfloat16) for _ in range(3))
    assert attention_ref(q, k, v, scale=0.3, causal=True).dtype == torch.bfloat16


@pytest.mark.parametrize("with_state", [False, True])
@pytest.mark.parametrize("t,dk,dv", [(1, 4, 4), (37, 8, 16), (70, 16, 8)])
def test_gla_recurrent_ref_matches_the_references(t, dk, dv, with_state):
    rng = np.random.default_rng(t + dk)
    q, k, v = _normal(rng, (t, dk)), _normal(rng, (t, dk)), _normal(rng, (t, dv))
    g = -rng.uniform(0.001, 0.5, (t, dk)).astype(np.float32)
    s0 = _normal(rng, (dk, dv)) if with_state else None
    o, s = gla_recurrent_ref(*(torch.from_numpy(x) for x in (q, k, v, g)),
                             initial_state=None if s0 is None else torch.from_numpy(s0))
    ro, rs = ref_gla_recurrent_ref(*(jnp.asarray(x) for x in (q, k, v, g)),
                                   initial_state=None if s0 is None else jnp.asarray(s0))
    np.testing.assert_allclose(o.numpy(), np.asarray(ro), rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(s.numpy(), np.asarray(rs), rtol=1e-5, atol=1e-5)


# -- the port's plain versions against the oracles -----------------------------------

@pytest.mark.parametrize("hq,hkv,sq,skv,causal", [(4, 2, 9, 9, True), (6, 3, 5, 11, False),
                                                  (2, 2, 70, 70, True), (4, 1, 13, 13, False)])
def test_flash_plain_version_matches_the_dense_oracle(hq, hkv, sq, skv, causal):
    rng = np.random.default_rng(hq * sq)
    b, d = 2, 16
    q = torch.from_numpy(_normal(rng, (b, hq, sq, d)))
    k = torch.from_numpy(_normal(rng, (b, hkv, skv, d)))
    v = torch.from_numpy(_normal(rng, (b, hkv, skv, d)))
    got = flash_attention_ref(q, k, v, causal=causal, scale=0.25)
    rep = hq // hkv
    for bi in range(b):
        for h in range(hq):
            want = attention_ref(q[bi, h], k[bi, h // rep], v[bi, h // rep],
                                 scale=0.25, causal=causal)
            np.testing.assert_allclose(got[bi, h].numpy(), want.numpy(), rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("t,dk,dv", [(64, 8, 16), (100, 16, 64), (130, 16, 8)])
def test_gla_chunked_plain_versions_match_the_recurrence(t, dk, dv):
    rng = np.random.default_rng(t)
    b, h = 1, 2
    q, k = _normal(rng, (b, h, t, dk)), _normal(rng, (b, h, t, dk))
    v = _normal(rng, (b, h, t, dv))
    g = -rng.uniform(0.001, 0.5, (b, h, t, dk)).astype(np.float32)
    args = [torch.from_numpy(x) for x in (q, k, v, g)]
    for fn in (gla_chunked_ref, gla_chunked):
        o, s = fn(*args)
        for hi in range(h):
            want_o, want_s = gla_recurrent_ref(*(x[0, hi] for x in args))
            np.testing.assert_allclose(o[0, hi].numpy(), want_o.numpy(), rtol=1e-4, atol=1e-4)
            np.testing.assert_allclose(s[0, hi].numpy(), want_s.numpy(), rtol=1e-4, atol=1e-4)


# -- build_model, RowPilot --------------------------------------------------------

@pytest.mark.parametrize("arch", ["internlm2-1.8b", "hymba-1.5b"])
def test_build_model_carries_the_references_weights(arch):
    from repro.configs import get_config as ref_get_config
    from repro.models import build_model as ref_build_model
    from repro_torch.configs import get_config
    from repro_torch.convert import model_params_from_arrays
    cfg = get_config(arch).reduced()
    model = build_model(cfg, device="cpu")
    assert isinstance(model, Model) and model.cfg is cfg
    assert model.embed.device == torch.device("cpu")
    ref_model = ref_build_model(ref_get_config(arch).reduced())
    params = ref_model.init(jax.random.PRNGKey(2))
    model.load_state_dict(model_params_from_arrays(
        cfg, jax.tree.map(np.asarray, params), device="cpu"))
    tokens = np.random.default_rng(5).integers(0, cfg.vocab_size, (2, 24)).astype(np.int32)
    got, _ = model({"tokens": torch.from_numpy(tokens)})
    want, _ = ref_model.forward(params, {"tokens": jnp.asarray(tokens)})
    np.testing.assert_allclose(got.float().numpy(), np.asarray(want, np.float32),
                               rtol=2e-5, atol=2e-5)


def test_row_pilot_statistics_are_bitwise_the_references():
    rng = np.random.default_rng(6)
    sums = rng.standard_normal((40, 3, 2)) * 100
    sq = rng.random((40, 3, 2)) * 1e4
    counts = rng.integers(0, 5, (40, 3)).astype(np.float64)
    counts[:, 2] = 0                        # an empty group: mean and var 0
    counts[:, 1] = 0
    counts[0, 1] = 1                        # one row: var 0
    got = quickr._row_pilot_stats(sums, sq, counts)
    want = ref_quickr._row_pilot_stats(sums, sq, counts)
    for a, b in zip(got, want):
        np.testing.assert_array_equal(np.asarray(a).view(np.int64), np.asarray(b).view(np.int64))
    mean, var, n = got
    pilot = quickr.RowPilot(int(n.sum()), {(g, c): mean[g, c] for g in range(3) for c in range(2)},
                            {(g, c): var[g, c] for g in range(3) for c in range(2)})
    ref_pilot = ref_quickr.RowPilot(int(n.sum()), pilot.mean, pilot.var)
    assert [f.name for f in dataclasses.fields(pilot)] == \
        [f.name for f in dataclasses.fields(ref_pilot)]
    assert pilot == quickr.RowPilot(ref_pilot.n_rows, ref_pilot.mean, ref_pilot.var)
