"""The host-side checks of the two backward kernels' wrappers, on the CPU.

``flash_attn.ops.backward_checks`` and ``gla_chunk.ops.backward_checks`` run
before every backward launch on the card (the TMA loads want 16-byte
aligned, contiguous tensors of the head dims the kernels are built for);
they look only at shapes, dtypes, strides and addresses, so CPU tensors
exercise every refusal here.  ``backward_grids`` and ``stats_floats`` size
the launches and the flash backward's scratch; ``_build.load`` holds the
flash backward library's CTA rows to the host's ``BWD_TILE_ROWS``.
"""

import pytest
import torch

from repro_torch.kernels import _build
from repro_torch.kernels.flash_attn import ops as flash_ops
from repro_torch.kernels.gla_chunk import ops as gla_ops


def _flash(b=1, hq=4, hkv=2, s=65, d=64, dtype=torch.bfloat16):
    q = torch.zeros((b, hq, s, d), dtype=dtype)
    k = torch.zeros((b, hkv, s, d), dtype=dtype)
    v = torch.zeros_like(k)
    o, do = torch.zeros_like(q), torch.zeros_like(q)
    lse = torch.zeros((b, hq, s), dtype=torch.float32)
    return dict(q=q, k=k, v=v, o=o, lse=lse, do=do)


def _misaligned(t):
    """t's values in a tensor whose base sits 4 bytes past a 16-byte
    boundary (contiguous, same shape and dtype)."""
    step = 4 // t.element_size()
    flat = torch.zeros(t.numel() + step, dtype=t.dtype)[step:]
    return flat.view(t.shape)


def test_flash_backward_checks_accept_what_the_kernels_take():
    for dtype, dims in flash_ops.HEAD_DIMS.items():
        for d in dims:
            flash_ops.backward_checks(**_flash(d=d, dtype=dtype))


@pytest.mark.parametrize("fault", ["head_dim", "head_dim_f32_256", "head_dim_bf16_16",
                                   "do_dtype", "o_shape", "lse_shape",
                                   "lse_dtype", "not_contiguous", "misaligned_q",
                                   "misaligned_lse", "misaligned_do"])
def test_flash_backward_checks_refuse(fault):
    t = _flash()
    if fault == "head_dim":
        t = _flash(d=32)
    elif fault == "head_dim_f32_256":   # each dtype its own widths
        t = _flash(d=256, dtype=torch.float32)
    elif fault == "head_dim_bf16_16":
        t = _flash(d=16)
    elif fault == "do_dtype":
        t["do"] = t["do"].float()
    elif fault == "o_shape":
        t["o"] = t["o"][:, :, :-1]
    elif fault == "lse_shape":
        t["lse"] = t["lse"][..., :-1].contiguous()
    elif fault == "lse_dtype":
        t["lse"] = t["lse"].double()
    elif fault == "not_contiguous":
        t["do"] = t["do"].transpose(2, 3).contiguous().transpose(2, 3)
    else:
        name = fault.split("_")[1]
        t[name] = _misaligned(t[name])
    with pytest.raises(ValueError):
        flash_ops.backward_checks(**t)


def test_flash_backward_grids_and_stats():
    """bf16: dQ CTAs of 128 q rows and dK/dV CTAs of 64 (d 64) or 128 (d
    128) kv rows, both of 64 rows at d 256; f32: 64-row CTAs; the stats
    scratch holds lse log2 e and delta of every row, rows padded to 64."""
    t = _flash(b=2, hq=25, hkv=5, s=2048, d=64)
    assert flash_ops.backward_grids(t["q"], t["k"]) == [(16 * 2, 25), (32 * 2, 5)]
    t = _flash(b=1, hq=6, hkv=3, s=200, d=128, dtype=torch.float32)
    assert flash_ops.backward_grids(t["q"], t["k"]) == [(4, 6), (4, 3)]
    assert flash_ops.stats_floats(t["q"]) == 2 * 6 * 256
    t = _flash(b=2, hq=16, hkv=8, s=4096, d=128)
    assert flash_ops.backward_grids(t["q"], t["k"]) == [(32 * 2, 16), (32 * 2, 8)]
    assert flash_ops.stats_floats(t["q"]) == 2 * 2 * 16 * 4096
    # bf16 d 256: dQ CTAs of one warpgroup (64 q rows), dK/dV CTAs of two
    # warpgroups over the same 64 kv rows; f32 d 16: 64-row CTAs
    t = _flash(b=2, hq=16, hkv=16, s=2048, d=256)
    assert flash_ops.backward_grids(t["q"], t["k"]) == [(32 * 2, 16), (32 * 2, 16)]
    t = _flash(b=1, hq=4, hkv=2, s=129, d=256)
    assert flash_ops.backward_grids(t["q"], t["k"]) == [(3, 4), (3, 2)]
    t = _flash(b=8, hq=4, hkv=2, s=65, d=16, dtype=torch.float32)
    assert flash_ops.backward_grids(t["q"], t["k"]) == [(2 * 8, 4), (2 * 8, 2)]


def test_flash_backward_tile_rows_cover_every_head_dim():
    """The host's table of CTA rows names exactly the widths the kernels
    take, each a whole number of 64-row warpgroup bands."""
    assert {dt: tuple(rows) for dt, rows in flash_ops.BWD_TILE_ROWS.items()} == \
        flash_ops.HEAD_DIMS
    for rows in flash_ops.BWD_TILE_ROWS.values():
        for q_rows, kv_rows in rows.values():
            assert q_rows % flash_ops.BWD_TILE == 0 and kv_rows % flash_ops.BWD_TILE == 0


class _FakeBwdLibrary:
    """Stands in for the flash_attn_bwd library on the CPU: reports the
    host's BWD_TILE_ROWS, or ``wrong`` for one (dtype code, head dim)."""

    def __init__(self, wrong=None):
        wrong = wrong or {}

        def tile_rows(code, d, q_rows, kv_rows):   # (dtype code, head dim, int*, int*)
            dtype = {c: t for t, c in _build.FLOAT_CODES.items()}[code]
            rows = wrong.get((code, d), flash_ops.BWD_TILE_ROWS[dtype].get(d))
            if rows is None:
                return 1   # cudaErrorInvalidValue
            q_rows._obj.value, kv_rows._obj.value = rows
            return 0

        # plain functions, so that load can set their argtypes and restype
        self.flash_attn_bwd_tile_rows = tile_rows
        self.flash_attn_bwd_launch = lambda *a: 0
        self.flash_attn_bwd_error_string = lambda code: b"error"


def _load_fake(monkeypatch, lib):
    """``_build.load("flash_attn_bwd")`` with ``lib`` in place of the built
    library (no nvcc, no card)."""
    monkeypatch.setattr(_build, "_libs", {})
    monkeypatch.setattr(_build, "build", lambda names: {n: f"/nonexistent/{n}.so" for n in names})
    monkeypatch.setattr(_build.ctypes, "CDLL", lambda path: lib)
    return _build.load("flash_attn_bwd")


def test_flash_backward_library_load_accepts_matching_tile_rows(monkeypatch):
    lib = _FakeBwdLibrary()
    assert _load_fake(monkeypatch, lib) is lib
    assert _build._libs["flash_attn_bwd"] is lib


@pytest.mark.parametrize("wrong", [((3, 256), (128, 64)), ((3, 64), (128, 128)),
                                   ((0, 16), (32, 32)), ((3, 128), None)])
def test_flash_backward_library_load_refuses_other_tile_rows(monkeypatch, wrong):
    """A library whose CTAs hold other rows than BWD_TILE_ROWS (or that does
    not know a width the host has) is refused when it is loaded, and not
    kept."""
    (code, d), rows = wrong
    lib = _FakeBwdLibrary({(code, d): rows})
    with pytest.raises(RuntimeError, match=f"d {d} CTAs"):
        _load_fake(monkeypatch, lib)
    assert "flash_attn_bwd" not in _build._libs


def _gla(b=1, h=3, t=130, dk=16, dv=64, dtype=torch.bfloat16, dstate=True):
    chunks = -(-t // gla_ops.CHUNK)
    x = dict(q=torch.zeros((b, h, t, dk), dtype=dtype), k=torch.zeros((b, h, t, dk), dtype=dtype),
             v=torch.zeros((b, h, t, dv), dtype=dtype), g=torch.zeros((b, h, t, dk), dtype=dtype),
             states=torch.zeros((b, h, chunks, dk, dv)), state=torch.zeros((b, h, dk, dv)),
             do=torch.zeros((b, h, t, dv), dtype=dtype))
    x["dstate"] = torch.zeros((b, h, dk, dv)) if dstate else None
    return x


def test_gla_backward_checks_accept_what_the_kernels_take():
    for dtype, widths in gla_ops.KEY_VALUE_DIMS.items():
        for dk, dv in widths:
            for dstate in (True, False):
                gla_ops.backward_checks(**_gla(dk=dk, dv=dv, dtype=dtype, dstate=dstate))


@pytest.mark.parametrize("fault", ["key_dim", "value_dim", "bf16_8_16", "f32_8_64",
                                   "do_dtype", "states_shape",
                                   "state_dtype", "dstate_shape", "not_contiguous",
                                   "misaligned_q", "misaligned_states"])
def test_gla_backward_checks_refuse(fault):
    x = _gla()
    if fault == "key_dim":
        x = _gla(dk=32)
    elif fault == "value_dim":
        x = _gla(dv=32)
    elif fault == "bf16_8_16":   # the reduced widths are built for f32 only
        x = _gla(dk=8, dv=16)
    elif fault == "f32_8_64":    # pairs, not any dk with any dv
        x = _gla(dk=8, dv=64, dtype=torch.float32)
    elif fault == "do_dtype":
        x["do"] = x["do"].float()
    elif fault == "states_shape":
        x["states"] = x["states"][:, :, :-1].contiguous()
    elif fault == "state_dtype":
        x["state"] = x["state"].double()
    elif fault == "dstate_shape":
        x["dstate"] = x["dstate"][..., :-1].contiguous()
    elif fault == "not_contiguous":
        x["v"] = x["v"].transpose(2, 3).contiguous().transpose(2, 3)
    else:
        name = fault.split("_")[1]
        x[name] = _misaligned(x[name])
    with pytest.raises(ValueError):
        gla_ops.backward_checks(**x)
