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
