#!/usr/bin/env python3
"""Split the GLA backward's chunk kernel into its phases, on one CUDA card.

    python3 tools/gla_bwd_phases.py

Builds a copy of ``gla_chunk/csrc/gla_chunk_bwd.cu`` (under
``build/prof/``, with nvcc's flags of ``repro_torch.kernels._build``) in
which thread 0 of 64 CTAs reads ``clock64()`` at the kernel's start, after
each ``__syncthreads()`` of ``gla_bwd_chunk_kernel`` and at its end; the
copy stands in for the library, a bf16 backward runs at hymba-1.5b's (2,
25, 2048, dk 16, dv 64) and at an rwkv6 point (1, 64, 2048, 64 / 64), and
the mean cycles of each phase over those CTAs are printed (SM cycles, with
the CTA's neighbour on the SM running beside it; at dk 64 the slab phases
are the last slab's).  The probes add a few instructions and are not in the
library the port builds.
"""

import ctypes
import os
import re
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)
sys.path.insert(0, os.path.join(ROOT, "src"))

PHASES = ["start to the first slab", "slab loads", "L (cumsum)", "B beside the factors",
          "A, dq and dk", "dv inter, dg", "A and dO by rows", "dv intra, stores"]


def _replace_once(text: str, old: str, new: str) -> str:
    if text.count(old) != 1:
        raise RuntimeError(f"the probe's anchor {old!r} is in the source "
                           f"{text.count(old)} times, not once")
    return text.replace(old, new)


def instrumented(src: str):
    """(source, probes): the chunk kernel with a probe at its start, after
    every barrier and at its end; raises if the source no longer has the
    anchors or the barriers that ``PHASES`` names."""
    a = src.index("    gla_bwd_chunk_kernel(")
    b = src.index("template <typename Kernel>")
    n = [0]

    def probe(m):
        n[0] += 1
        return m.group(0) + f" PROF({n[0]});"

    body = re.sub(r"__syncthreads\(\);", probe, src[a:b])
    if n[0] + 1 != len(PHASES):
        raise RuntimeError(f"the chunk kernel has {n[0]} barriers; PHASES names "
                           f"{len(PHASES)} phases, so it expects {len(PHASES) - 1}")
    body = _replace_once(body, "  const int warp = tid / 32, lane = tid % 32;\n",
                         "  const int warp = tid / 32, lane = tid % 32;\n  PROF(0);\n")
    last = body.rstrip().rfind("}")
    body = body[:last] + f"  PROF({n[0] + 1});\n" + body[last:]
    head = _replace_once(src[:a], "namespace repro_torch {", """namespace repro_torch {
__device__ long long g_prof[64][32];
#define PROF(i)                                                               \\
  do {                                                                        \\
    if (threadIdx.x == 0 && blockIdx.x < 8 && blockIdx.y < 8)                 \\
      g_prof[blockIdx.y * 8 + blockIdx.x][i] = clock64();                     \\
  } while (0)
""")
    tail = """
extern "C" int gla_prof_read(long long* dst) {
  return static_cast<int>(cudaMemcpyFromSymbol(dst, repro_torch::g_prof,
                                               sizeof(repro_torch::g_prof)));
}
"""
    return head + body + src[b:] + tail, n[0] + 2


def main() -> int:
    import numpy as np
    import torch
    if not torch.cuda.is_available():
        print("gla_bwd_phases: no CUDA device", file=sys.stderr)
        return 2
    import chip_smoke as cs
    from backward_profile import variant_library
    from repro_torch.kernels import _build
    from repro_torch.kernels.gla_chunk import ops as gla_ops
    kernels_dir = os.path.join(ROOT, "src", "repro_torch", "kernels")
    src = open(os.path.join(kernels_dir, "gla_chunk", "csrc", "gla_chunk_bwd.cu")).read()
    text, probes = instrumented(src)
    lib = variant_library("gla_chunk_bwd", text, kernels_dir, "phases")
    lib.gla_prof_read.argtypes = [ctypes.c_void_p]
    lib.gla_prof_read.restype = ctypes.c_int
    _build.build(["gla_chunk"])
    _build._libs["gla_chunk_bwd"] = lib
    dev = torch.device("cuda")
    smi = cs.nvidia_smi_line()
    for dk, (b, h, t) in ((16, (2, 25, 2048)), (64, (1, 64, 2048))):
        rng = np.random.default_rng(5)

        def normal(shape, scale=1.0):
            a = (rng.standard_normal(shape) * scale).astype(np.float32)
            return torch.from_numpy(a).to(dev).to(torch.bfloat16)

        q, k = normal((b, h, t, dk), 0.5), normal((b, h, t, dk), 0.5)
        v, do = normal((b, h, t, 64)), normal((b, h, t, 64))
        g = torch.from_numpy(-rng.uniform(0.0, 0.3, (b, h, t, dk)).astype(np.float32))
        g = g.to(dev).to(torch.bfloat16)
        _, st, states = gla_ops._forward(q, k, v, g)
        for _ in range(3):
            gla_ops._backward(q, k, v, g, states, st, do, None)
        torch.cuda.synchronize()
        stamps = np.zeros((64, 32), np.int64)
        if lib.gla_prof_read(stamps.ctypes.data):
            raise RuntimeError("reading the probes failed")
        if not (stamps[:, :probes] > 0).all():
            raise RuntimeError("a probe wrote no stamp: a CTA the probes sample ran no kernel "
                               "or missed a probe")
        cycles = np.diff(stamps[:, :probes], axis=1).mean(axis=0)
        total = cycles.sum()
        print(f"[phases] gla_bwd_chunk_kernel bf16 {(b, h, t, dk, 64)}: {total:,.0f} SM cycles "
              f"a CTA, mean of 64  [{smi}]")
        for name, c in zip(PHASES, cycles):
            print(f"[phases]   {c:9,.0f} cycles  {c / total:6.1%}  {name}")
    print(smi)
    return 0


if __name__ == "__main__":
    sys.exit(main())
