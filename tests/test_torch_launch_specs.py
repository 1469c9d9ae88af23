"""``launch/specs.py`` of the port against the reference's, on the CPU: for
every architecture of the registry and every shape of ``SHAPES`` (40
cells), ``cell_supported`` equal, and ``input_specs`` the reference's
``ShapeDtypeStruct`` tree key for key, shape for shape and dtype for dtype
(exact: both are integer shapes and type names, nothing computed).
"""

import dataclasses

import numpy as np
import pytest
import torch

from repro.launch import specs as ref_specs
from repro_torch.configs import get_config, list_architectures
from repro_torch.launch import specs

DTYPES = {torch.int32: np.dtype(np.int32), torch.float32: np.dtype(np.float32),
          torch.bfloat16: "bfloat16"}


def test_shapes_are_the_references():
    assert list(specs.SHAPES) == list(ref_specs.SHAPES)
    for name, shape in specs.SHAPES.items():
        assert dataclasses.asdict(shape) == dataclasses.asdict(ref_specs.SHAPES[name])


def _same(got, want, where):
    if isinstance(want, dict):
        assert isinstance(got, dict) and got.keys() == want.keys(), where
        for k in want:
            _same(got[k], want[k], f"{where}.{k}")
        return
    shape, dtype = got
    assert tuple(shape) == tuple(want.shape), where
    assert np.dtype(want.dtype) == np.dtype(DTYPES[dtype]), where


@pytest.mark.parametrize("shape", sorted(specs.SHAPES))
@pytest.mark.parametrize("arch", list_architectures())
def test_input_specs_and_cell_support_equal_the_references(arch, shape):
    from repro.configs import get_config as ref_get_config
    cfg, ref_cfg = get_config(arch), ref_get_config(arch)
    assert specs.cell_supported(cfg, specs.SHAPES[shape]) == \
        ref_specs.cell_supported(ref_cfg, ref_specs.SHAPES[shape])
    want = ref_specs.input_specs(ref_cfg, shape)
    got = specs.input_specs(cfg, shape)
    _same(got, want, f"{arch}/{shape}")
