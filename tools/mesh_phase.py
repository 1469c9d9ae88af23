#!/usr/bin/env python3
"""chip_smoke.py's phase 17 (the device mesh) alone, on one CUDA card.

    python3 tools/mesh_phase.py

Builds every kernel (``repro_torch.kernels._build.build``), then runs
``chip_smoke.run_mesh``: internlm2-1.8b at full width, 2 layers, trained on a
one-rank NCCL (1, 1) host mesh with its state sharded against the unsharded
steps (bitwise), the elastic restore of the sharded checkpoint onto the mesh
and onto no mesh, the dry run's host-mesh cell against the card's step
(FLOPs equal, peak within 15 %), five production cells of the dry run on
the fake (16, 16) mesh (two of them MoE), and olmoe-1b-7b at full width, 2
layers, on the host mesh with its MoE FFN expert-parallel, bitwise the
unsharded steps; the same checks as in ``chip_smoke.py``, which fail the
script.  Prints the phase's lines, one JSON line of its summary,
and the card's name and power limit last.
"""

import json
import os
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)
sys.path.insert(0, os.path.join(ROOT, "src"))


def main() -> int:
    import numpy as np
    import torch
    if not torch.cuda.is_available():
        print("mesh_phase: no CUDA device", file=sys.stderr)
        return 2
    import chip_smoke
    from repro_torch.kernels import _build
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    t0 = time.perf_counter()
    _build.build()
    print(f"[build] {len(_build.KERNELS)} kernels in {time.perf_counter() - t0:.2f} s")
    smi = chip_smoke.nvidia_smi_line()
    summary = chip_smoke.run_mesh(torch, np, smi)
    print(json.dumps(summary, default=str))
    print(smi)
    return 0


if __name__ == "__main__":
    sys.exit(main())
