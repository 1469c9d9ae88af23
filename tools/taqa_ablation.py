#!/usr/bin/env python3
"""Where the time of the taqa_solve kernels goes, on one CUDA card.

    python3 tools/taqa_ablation.py [--out FILE]

Builds variants of ``src/repro_torch/kernels/taqa_solve/csrc/taqa_solve.cu``
by removing or replacing one part at a time (text patches of this tree's
source; the script fails if a patch no longer applies), and times each with
CUDA events at phase-10-like inputs: the solve at a 1,024-block pilot with
one channel, two channels, and a SUM + COUNT pair (the COUNT channel's
block sums are constant, so its var_ub is 0); the draw over 1,875,000 and
18,750,000 uniforms at theta 0.00015.  Three protocols: L2 flushed by a
256 MB ``zero_()`` (chip_smoke.py's time_cold), flushed by a 256 MB read,
and warm.  The variants other than ``full``, ``no_zero_guards``,
``tiles_of_4096`` and ``no_back_off`` compute
wrong answers: they are for timing only.  Prints one JSON line per variant
and the card's name and power limit.
"""

import argparse
import ctypes
import json
import os
import statistics
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SRC = os.path.join(ROOT, "src", "repro_torch", "kernels", "taqa_solve", "csrc",
                   "taqa_solve.cu")
BUILD = os.path.join(ROOT, "build", "ablation")

SOLVE = {
    "full": [],
    "no_rounds": [("for (int done = 0, round = 0; done < kSteps; ++round) {",
                   "for (int done = kSteps, round = 0; done < kSteps; ++round) {")],
    "no_row_sums": [("for (int j0 = g * kPass; j0 < n_solve; j0 += groups * kPass) {",
                     "for (int j0 = n_solve; j0 < n_solve; j0 += groups * kPass) {")],
    "replay_depth_0": [("mid = replay(lo, hi, static_cast<unsigned>(path), depth);",
                        "mid = replay(lo, hi, static_cast<unsigned>(path), 0);")],
    "cheap_feasible": [("&& !feasible(c, N, mid)) {", "&& !(mid < c.e * 0.01f)) {")],
    "no_zero_guards": [
        ("    u_v = num == 0.0f ? num : __fdiv_rn(num == 0.0f ? 1.0f : num, max_nan(n_lb, 1e-30f));",
         "    u_v = __fdiv_rn(num, max_nan(n_lb, 1e-30f));"),
        ("  const float root = exact ? v : __fsqrt_rn(exact ? 1.0f : v);",
         "  const float root = __fsqrt_rn(v);")],
}
DRAW = {
    "full": [],
    "no_zero_fill": [("    if (i < n) padded[i] = 0;\n", "")],
    "no_look_back": [("      excl = look_back(status, tile, epoch, lane);", "      excl = 0;")],
    "tiles_of_4096": [("constexpr int kDrawThreads = 1024;", "constexpr int kDrawThreads = 256;")],
    "no_back_off": [("      __nanosleep(100);\n", "")],
}


def patched(base, pairs):
    for old, new in pairs:
        if old not in base:
            raise SystemExit(f"taqa_ablation: patch no longer applies: {old[:60]!r}")
        base = base.replace(old, new, 1)
    return base


def build(variants, base):
    """{name: ctypes library}, every nvcc started together."""
    os.makedirs(BUILD, exist_ok=True)
    nvcc = os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"), "bin", "nvcc")
    procs = {}
    for name, pairs in variants.items():
        cu = os.path.join(BUILD, f"{name}.cu")
        with open(cu, "w") as f:
            f.write(patched(base, pairs))
        procs[name] = subprocess.Popen(
            [nvcc, "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3", "-shared",
             "-Xcompiler", "-fPIC", "-o", os.path.join(BUILD, f"lib{name}.so"), cu],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    libs = {}
    P, I, L = ctypes.c_void_p, ctypes.c_int, ctypes.c_int64
    for name, proc in procs.items():
        out = proc.communicate()[0]
        if proc.returncode:
            raise SystemExit(f"taqa_ablation: nvcc failed for {name}:\n{out}")
        lib = ctypes.CDLL(os.path.join(BUILD, f"lib{name}.so"))
        lib.taqa_solve_rate_launch.argtypes = [P, L, I, P, I, P, I, P, P, P, P, P]
        lib.taqa_draw_compact_launch.argtypes = [P, L, P, P, P, P, P]
        libs[name] = lib
    return libs


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out", help="also write the JSON lines here")
    args = ap.parse_args()
    import numpy as np
    import torch
    if not torch.cuda.is_available():
        print("taqa_ablation: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, ROOT)
    sys.path.insert(0, os.path.join(ROOT, "src"))
    from chip_smoke import nvidia_smi_line, solve_point
    from repro_torch.kernels.taqa_solve import ops as taqa_ops
    from repro_torch.kernels.taqa_solve import taqa_draw_compact_ref, taqa_solve_rate_ref
    dev = torch.device("cuda", torch.cuda.current_device())
    stream = lambda: torch.cuda.current_stream(dev).cuda_stream
    with open(SRC) as f:
        base = f.read()
    solve_libs = build({f"solve_{k}": v for k, v in SOLVE.items()}, base)
    draw_libs = build({f"draw_{k}": v for k, v in DRAW.items()}, base)
    flush = torch.empty(256 << 20, dtype=torch.uint8, device=dev)

    def timed(fn, protocol, iters=30):
        fn()
        times = []
        for _ in range(iters):
            if protocol == "write_flush":
                flush.zero_()
            elif protocol == "read_flush":
                flush.max()
            torch.cuda._sleep(1_000_000)   # the events bracket device work only
            a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            a.record()
            fn()
            b.record()
            b.synchronize()
            times.append(a.elapsed_time(b))
        return round(statistics.median(times) * 1e3, 2)

    def solve(lib, bs, present, n_real, ch, sv, scal):
        theta = torch.empty(2, device=dev)
        flags = torch.empty(1, dtype=torch.int32, device=dev)
        rc = lib.taqa_solve_rate_launch(bs.data_ptr(), bs.shape[0], bs.shape[1],
                                        present.data_ptr(), n_real, ch.data_ptr(), ch.shape[0],
                                        sv.data_ptr(), scal.data_ptr(), theta.data_ptr(),
                                        flags.data_ptr(), stream())
        assert rc == 0, rc
        return theta, flags

    sum_count = list(solve_point(torch, np, 1024, 1, dev))
    sum_count[3] = torch.tensor([0, 1], dtype=torch.int32, device=dev)  # column 1: counts
    sum_count[4] = sum_count[4].repeat(2, 1).contiguous()
    solve_inputs = {"1_channel": solve_point(torch, np, 1024, 1, dev),
                    "2_channels": solve_point(torch, np, 1024, 2, dev),
                    "sum_count": tuple(sum_count)}
    lines = []
    for name, lib in solve_libs.items():
        row = {"variant": name}
        for tag, inputs in solve_inputs.items():
            if name in ("solve_full", "solve_no_zero_guards"):
                got, want = solve(lib, *inputs), taqa_solve_rate_ref(*inputs)
                assert torch.equal(got[0].view(torch.int32), want[0].view(torch.int32))
                assert torch.equal(got[1], want[1])
            for protocol in ("write_flush", "read_flush", "warm"):
                row[f"{tag}/{protocol}_us"] = timed(lambda: solve(lib, *inputs), protocol)
        lines.append(row)
    scratch = {}

    def draw(name, u, th):
        if name not in scratch:   # each variant its own scratch, made as the wrapper makes it
            buf = torch.zeros(taqa_ops.SCRATCH_WORDS, dtype=torch.int64)
            buf[0] = 1 << 32
            scratch[name] = buf.to(dev)
        padded = torch.empty(u.shape[0], dtype=torch.int32, device=dev)
        nsel = torch.empty(1, dtype=torch.int32, device=dev)
        rc = draw_libs[name].taqa_draw_compact_launch(
            u.data_ptr(), u.shape[0], th.data_ptr(), scratch[name].data_ptr(), padded.data_ptr(),
            nsel.data_ptr(), stream())
        assert rc == 0, rc
        return nsel, padded

    th = torch.tensor([0.00015], dtype=torch.float32, device=dev)
    uniforms = {n: torch.rand(n, generator=torch.Generator(device=dev).manual_seed(5),
                              device=dev) for n in (1_875_000, 18_750_000)}
    for name in draw_libs:
        row = {"variant": name}
        for n, u in uniforms.items():
            if name in ("draw_full", "draw_tiles_of_4096", "draw_no_back_off"):
                got, want = draw(name, u, th), taqa_draw_compact_ref(u, th)
                assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
            for protocol in ("write_flush", "read_flush", "warm"):
                row[f"{n}/{protocol}_us"] = timed(lambda: draw(name, u, th), protocol)
        lines.append(row)
    smi = nvidia_smi_line()
    for row in lines:
        row["card"] = smi
        print(json.dumps(row))
    if args.out:
        with open(args.out, "w") as f:
            f.writelines(json.dumps(row) + "\n" for row in lines)
    print(smi)
    return 0


if __name__ == "__main__":
    sys.exit(main())
