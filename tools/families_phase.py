#!/usr/bin/env python3
"""chip_smoke.py's phases 14-16 alone, on one CUDA card.

    python3 tools/families_phase.py

Builds every kernel (``repro_torch.kernels._build.build``), then runs
``chip_smoke.run_families`` (whisper-large-v3, llava-next-34b and gemma-7b
at full width, 2 layers: prefill + decode against the teacher-forced
forward, 3 training steps, the flash kernels forward and backward at the
models' own inputs), ``chip_smoke.run_reduced`` (every text config's
``.reduced()`` through ``launch.serve`` and ``launch.train`` on the card,
then the reduced widths' kernels at their recorded inputs) and
``chip_smoke.run_remat_groups`` (internlm2-1.8b at full depth, remat_groups
4 against per-block remat, bitwise); the same checks as in
``chip_smoke.py``, which fail the script.  Prints the phases' lines, one
JSON line of their summary, and the card's name and power limit last.
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
        print("families_phase: no CUDA device", file=sys.stderr)
        return 2
    import chip_smoke
    from repro_torch.kernels import _build
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    t0 = time.perf_counter()
    _build.build()
    print(f"[build] {len(_build.KERNELS)} kernels in {time.perf_counter() - t0:.2f} s")
    lib = _build.load("filtered_agg")

    def launch_floor(gx, gy):
        rc = lib.column_floor_launch(gx, gy, torch.cuda.current_stream().cuda_stream)
        _build.check(lib, "filtered_agg", rc)

    smi = chip_smoke.nvidia_smi_line()
    summary = {"families": chip_smoke.run_families(torch, np, smi, launch_floor),
               "reduced": chip_smoke.run_reduced(torch, np, smi, launch_floor),
               "remat_groups": chip_smoke.run_remat_groups(torch, np, smi)}
    print(json.dumps(summary, default=str))
    print(smi)
    return 0


if __name__ == "__main__":
    sys.exit(main())
