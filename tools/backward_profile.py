#!/usr/bin/env python3
"""Time the two training backward kernels at the training paths' inputs and
split each call's device time by kernel, on one CUDA card.

    python3 tools/backward_profile.py [--src DIR] [--iters N]

``DIR`` is the ``src`` directory whose ``repro_torch`` to load (default:
this checkout's), so that two trees can be compared in one call.  Inputs
are seeded normals at internlm2-1.8b's (2, 16 / 8 heads, 4096, 128) causal,
hymba-1.5b's (2, 25 / 5 heads, 2048, 64) window-1024 and gemma-7b's (2, 16
heads, 2048, 256) causal attention, and GLA at hymba's (2, 25, 2048, dk 16,
dv 64) and rwkv6's (1, 64, 2048, dk 64, dv 64), all bf16.  For each: the
backward's median device time with the L2 flushed before every launch (CUDA
events, ``chip_smoke.time_cold``), SDPA's backward on the same inputs for
flash, the bound (``chip_smoke.least_ms``), for flash the launch floor of
its two grids (an empty kernel on each, ``ops.backward_grids``), and one
``torch.profiler`` window of ``N`` backward calls (L2 not flushed) split by
device kernel (ms per call).  For flash at d 64 the backward is timed once
more with a variant library built from a copy of the tree's
``flash_attn_bwd.cu`` whose dK/dV CTAs hold 128 kv rows (two warpgroups,
as at d 128) instead of 64;
the copy goes under ``build/prof/`` and the library the port builds is not
changed.  Prints one line per input and kernel, one JSON line, and the card's name
and power limit last.
"""

import argparse
import ctypes
import json
import os
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

FLASH_POINTS = [("internlm2", (2, 16, 8, 4096, 128), True, 0),
                ("hymba", (2, 25, 5, 2048, 64), True, 1024),
                ("gemma-7b", (2, 16, 16, 2048, 256), True, 0)]
GLA_POINTS = [("hymba", (2, 25, 2048, 16)), ("rwkv6", (1, 64, 2048, 64))]


# the dK/dV CTA's warpgroups in BwdShape (csrc/flash_attn_bwd.cu), and the
# variant's
WG_CHOICE = "  static constexpr int kKvWg = D == 64 ? 1 : 2;\n"
WG_WIDE = "  static constexpr int kKvWg = 2;\n"


def variant_library(name: str, text: str, kernels_dir: str, tag: str):
    """Kernel ``name``'s library built from ``text``, a variant of its
    ``.cu`` (under ``build/prof/``, with nvcc's flags of
    ``repro_torch.kernels._build``), bound as ``_build.load`` binds it; to
    stand in for the library: ``_build._libs[name] = lib``."""
    from repro_torch.kernels import _build
    text = text.replace('#include "../../csrc/', f'#include "{kernels_dir}/csrc/')
    out_dir = os.path.join(ROOT, "build", "prof")
    os.makedirs(out_dir, exist_ok=True)
    cu, so = (os.path.join(out_dir, f"{name}_{tag}.cu"),
              os.path.join(out_dir, f"lib{name}_{tag}.so"))
    with open(cu, "w") as f:
        f.write(text)
    built = subprocess.run([_build._nvcc(), *_build.NVCC_FLAGS, "-o", so, cu],
                           capture_output=True, text=True)
    if built.returncode:
        raise RuntimeError(f"building {cu} failed:\n{built.stdout}{built.stderr}")
    lib = ctypes.CDLL(so)
    for fn, argtypes in _build._SIGNATURES[name].items():
        getattr(lib, fn).argtypes = argtypes
        getattr(lib, fn).restype = ctypes.c_int
    getattr(lib, f"{name}_error_string").argtypes = [ctypes.c_int]
    getattr(lib, f"{name}_error_string").restype = ctypes.c_char_p
    return lib


def kernel_split(torch, fn, iters):
    """[(device kernel, ms per call, launches per call)] of ``iters`` calls
    under torch.profiler, largest first."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
    rows = [(ev.key, ev.self_device_time_total / 1e3 / iters, ev.count / iters)
            for ev in prof.key_averages()
            if ev.device_type == DeviceType.CUDA and ev.self_device_time_total > 0]
    return sorted(rows, key=lambda r: -r[1])


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--src", default=os.path.join(ROOT, "src"))
    ap.add_argument("--iters", type=int, default=10)
    args = ap.parse_args()
    import numpy as np
    import torch
    if not torch.cuda.is_available():
        print("backward_profile: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, os.path.abspath(args.src))
    import chip_smoke as cs
    from repro_torch.kernels import _build
    from repro_torch.kernels.flash_attn import ops as flash_ops
    from repro_torch.kernels.gla_chunk import ops as gla_ops
    _build.build(["filtered_agg", "flash_attn", "flash_attn_bwd", "gla_chunk", "gla_chunk_bwd"])
    floor_lib = _build.load("filtered_agg")

    def launch_floor(gx, gy):   # an empty kernel on a (gx, gy) grid (chip_smoke.py phase 3)
        rc = floor_lib.column_floor_launch(gx, gy, torch.cuda.current_stream().cuda_stream)
        _build.check(floor_lib, "filtered_agg", rc)

    kernels_dir = os.path.dirname(os.path.abspath(_build.__file__))
    bwd_src = open(os.path.join(kernels_dir, "flash_attn", "csrc", "flash_attn_bwd.cu")).read()
    wide = (variant_library("flash_attn_bwd", bwd_src.replace(WG_CHOICE, WG_WIDE), kernels_dir,
                            "wide") if bwd_src.count(WG_CHOICE) == 1 else None)
    smi = cs.nvidia_smi_line()
    dev = torch.device("cuda")

    def normal(rng, shape, scale=1.0):
        a = (rng.standard_normal(shape) * scale).astype(np.float32)
        return torch.from_numpy(a).to(dev).to(torch.bfloat16)

    out = []
    for name, (b, hq, hkv, s, d), causal, window in FLASH_POINTS:
        rng = np.random.default_rng(s + d)
        q, k, v, do = (normal(rng, (b, h, s, d)) for h in (hq, hkv, hkv, hq))
        scale = 1.0 / d ** 0.5
        o, lse = flash_ops._forward(q, k, v, causal, window, scale, True)
        call = lambda: flash_ops._backward(q, k, v, o, lse, do, causal, window, scale)
        ms = cs.time_cold(torch, call, iters=args.iters)
        sdpa_ms = cs.time_cold(torch, cs.sdpa_backward(torch, q, k, v, do, causal, window),
                               iters=args.iters)
        bound_ms, by = cs.least_ms(*cs.flash_bwd_work(np, q, k, causal, window), q.dtype)
        grids = flash_ops.backward_grids(q, k)
        floor_ms = sum(cs.time_cold(torch, lambda g=g: launch_floor(*g), iters=args.iters)
                       for g in grids)
        split = kernel_split(torch, call, args.iters)
        by_rows, same = {}, None
        if d == 64 and wide is not None:
            by_rows[64], grads = ms, call()
            own, _build._libs["flash_attn_bwd"] = _build.load("flash_attn_bwd"), wide
            try:
                same = all(torch.equal(a, b) for a, b in zip(grads, call()))
                by_rows[128] = cs.time_cold(torch, call, iters=args.iters)
            finally:
                _build._libs["flash_attn_bwd"] = own
        out.append({"kernel": "flash_attention_bwd", "input": name, "shape": [b, hq, hkv, s, d],
                    "window": window, "ms": ms, "sdpa_backward_ms": sdpa_ms,
                    "bound_ms": bound_ms, "bound_by": by, "grids": grids, "floor_ms": floor_ms,
                    "split": split, "ms_by_kv_rows": by_rows,
                    "kv_rows_128_bitwise_equal": same})
        del q, k, v, do, o, lse
    for name, (b, h, t, dk) in GLA_POINTS:
        rng = np.random.default_rng(t + dk)
        q, k = normal(rng, (b, h, t, dk), 0.5), normal(rng, (b, h, t, dk), 0.5)
        v, do = normal(rng, (b, h, t, 64)), normal(rng, (b, h, t, 64))
        g = torch.from_numpy(-rng.uniform(0.0, 0.3, (b, h, t, dk)).astype(np.float32))
        g = g.to(dev).to(torch.bfloat16)
        _, st, states = gla_ops._forward(q, k, v, g)
        call = lambda: gla_ops._backward(q, k, v, g, states, st, do, None)
        ms = cs.time_cold(torch, call, iters=args.iters)
        bound_ms, by = cs.least_ms(*cs.gla_bwd_work(q, v), q.dtype)
        split = kernel_split(torch, call, args.iters)
        out.append({"kernel": "gla_chunked_bwd", "input": name, "shape": [b, h, t, dk, 64],
                    "ms": ms, "bound_ms": bound_ms, "bound_by": by, "split": split})
        del q, k, v, do, g, st, states
    for r in out:
        lib = (f", SDPA backward {r['sdpa_backward_ms'] * 1e3:.2f} us"
               if "sdpa_backward_ms" in r else "")
        if "floor_ms" in r:
            lib += f", launch floor of grids {r['grids']} {r['floor_ms'] * 1e3:.2f} us"
        lib += "".join(f"; dK/dV CTAs of {rows} kv rows {t * 1e3:.2f} us"
                       for rows, t in r.get("ms_by_kv_rows", {}).items())
        if r.get("kv_rows_128_bitwise_equal") is not None:
            lib += f", gradients bitwise equal: {r['kv_rows_128_bitwise_equal']}"
        print(f"[bwd] {r['kernel']} {r['input']} {r['shape']}: {r['ms'] * 1e3:.2f} us "
              f"(L2 flushed; bound {r['bound_ms'] * 1e3:.3f} us by {r['bound_by']}, "
              f"{r['bound_ms'] / r['ms']:.1%}{lib})  [{smi}]")
        for kname, kms, n in r["split"]:
            print(f"[bwd]   {kms * 1e3:10.2f} us x{n:g}  {kname[:110]}")
    print(json.dumps({"src": os.path.abspath(args.src), "points": out}))
    print(smi)
    return 0


if __name__ == "__main__":
    sys.exit(main())
