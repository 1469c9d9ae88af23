#!/usr/bin/env python3
"""chip_smoke.py's phase 13 (training) alone, on one CUDA card.

    python3 tools/train_phase.py

Builds every kernel (``repro_torch.kernels._build.build``), then runs
``chip_smoke.run_train``: the backward kernels against their plain
versions, internlm2-1.8b at full width through ``launch.train.main``, one
step's gradients against the plain versions, hymba-1.5b at full width, the
bitwise resume, and the backward kernels timed at the training inputs; the
same checks as in ``chip_smoke.py``, which fail the script.  About 70 s
against the whole script's six minutes, and on a card that has run nothing
else first.  Prints the phase's lines, one JSON line of its summary, and
the card's name and power limit last.
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
        print("train_phase: no CUDA device", file=sys.stderr)
        return 2
    import chip_smoke
    from repro_torch.kernels import _build
    torch.backends.cuda.matmul.allow_tf32 = False
    t0 = time.perf_counter()
    _build.build()
    print(f"[build] {len(_build.KERNELS)} kernels in {time.perf_counter() - t0:.2f} s")
    lib = _build.load("filtered_agg")

    def launch_floor(gx, gy):
        rc = lib.column_floor_launch(gx, gy, torch.cuda.current_stream().cuda_stream)
        _build.check(lib, "filtered_agg", rc)

    smi = chip_smoke.nvidia_smi_line()
    summary = chip_smoke.run_train(torch, np, smi, launch_floor)
    print(json.dumps(summary, default=str))
    print(smi)
    return 0


if __name__ == "__main__":
    sys.exit(main())
