"""Helpers shared by the tests that hold ``repro_torch`` to ``repro``.

Both packages receive the same bytes: the reference builds its tables with
numpy, and :func:`port_catalog` hands them to the port as numpy arrays
through ``repro_torch.convert``.
"""

import numpy as np

from repro_torch.convert import catalog_from_arrays


def table_arrays(table) -> dict:
    """A reference BlockTable as the plain arrays ``repro_torch.convert``
    takes."""
    return {
        "columns": {c: np.asarray(v) for c, v in table.columns.items()},
        "valid": np.asarray(table.valid),
        "block_id": np.asarray(table.block_id),
        "block_rows": table.block_rows,
        "num_rows": table.num_rows,
        "num_origin_blocks": table.num_origin_blocks,
    }


def port_catalog(ref_catalog, device="cpu"):
    """The port's copy of a reference catalog, on ``device``."""
    return catalog_from_arrays(
        {name: table_arrays(t) for name, t in ref_catalog.items()}, device)


Q6 = ("SELECT SUM(l_extendedprice * l_discount) AS revenue FROM lineitem "
      "WHERE l_shipdate BETWEEN 100 AND 1500 AND l_discount BETWEEN 0.02 AND 0.08")
SUM_COUNT = ("SELECT SUM(l_extendedprice) AS s, COUNT(*) AS n FROM lineitem")


def both_models(arch, overrides=None, seed=1):
    """(reference model, its params, the port's CPU model with those weights)
    of the reduced ``arch`` config with ``overrides``: the weights drawn by
    the reference and carried over bit for bit."""
    import jax

    from repro.configs import get_config as ref_get_config
    from repro.models import build_model as ref_build_model
    from repro_torch.configs import get_config
    from repro_torch.convert import model_params_from_arrays
    from repro_torch.models import Model

    overrides = overrides or {}
    ref_model = ref_build_model(ref_get_config(arch).reduced(**overrides))
    params = ref_model.init(jax.random.PRNGKey(seed))
    cfg = get_config(arch).reduced(**overrides)
    model = Model(cfg, device="cpu")
    model.load_state_dict(model_params_from_arrays(
        cfg, jax.tree.map(np.asarray, params), device="cpu"))
    return ref_model, params, model


def bind_train_state(model, ref_state):
    """The port's TrainState of the reference's ``ref_state``, on ``model``'s
    own parameters (its state dict loaded from the reference's, gradients
    switched on)."""
    import jax

    from repro_torch.convert import train_state_from_arrays
    from repro_torch.train import step

    st = jax.tree.map(np.asarray, ref_state)
    ported = train_state_from_arrays(model.cfg, st.params, st.opt._asdict(), st.residual,
                                     device="cpu")
    model.load_state_dict(ported.params)
    model.requires_grad_(True)
    return step.TrainState(dict(model.named_parameters()), ported.opt, ported.residual)


def both_train_states(arch, overrides=None, *, compress=False, seed=1):
    """(reference model, its TrainState, the port's model, its TrainState on
    the model's parameters), both from the reference's weights
    (``both_models``); a zero f32 residual on both sides with
    ``compress``."""
    import jax
    import jax.numpy as jnp

    from repro.train import optimizer as ref_opt
    from repro.train import step as ref_step

    ref_model, params, model = both_models(arch, overrides, seed=seed)
    ref_state = ref_step.TrainState(
        params, ref_opt.init_opt_state(params),
        jax.tree.map(lambda p: jnp.zeros(p.shape, jnp.float32), params) if compress else None)
    return ref_model, ref_state, model, bind_train_state(model, ref_state)


def assert_tree_close(got, want, rel, what):
    """Every leaf: max |got - want| <= rel * max |want| (and <= rel when the
    leaf is all zeros)."""
    import jax

    flat = jax.tree_util.tree_flatten_with_path(want)[0]
    gflat = jax.tree_util.tree_flatten_with_path(got)[0]
    assert [p for p, _ in flat] == [p for p, _ in gflat], what
    for (path, w), (_, g) in zip(flat, gflat):
        w, g = np.asarray(w, np.float64), np.asarray(g, np.float64)
        assert g.shape == w.shape, (what, path)
        err = np.abs(g - w).max()
        assert err <= rel * max(np.abs(w).max(), 1.0), (what, jax.tree_util.keystr(path), err,
                                                         np.abs(w).max())


def spec_batch(cfg, kind, batch, seq, seed):
    """numpy arrays of ``launch.specs.batch_specs(cfg, ShapeSpec(kind,
    batch, seq))``: tokens and labels uniform over the vocabulary, frames and
    patch embeddings standard normal, in the specs' dtypes."""
    import torch

    from repro_torch.launch.specs import ShapeSpec, batch_specs

    rng = np.random.default_rng(seed)
    out = {}
    for name, (shape, dtype) in batch_specs(cfg, ShapeSpec(kind, kind, seq, batch)).items():
        out[name] = (rng.integers(0, cfg.vocab_size, shape).astype(np.int32)
                     if dtype == torch.int32 else rng.standard_normal(shape).astype(np.float32))
    return out
