"""Roofline of the port's dry run: the reference's ``launch/roofline.py``
arithmetic at one NVIDIA H100's constants, over ``launch.dryrun``'s JSON.

Per (arch x shape) cell, per device (every rank runs the same shards):

  compute    = FLOPs/dev / peak FLOP/s        (989 TFLOP/s bf16, dense)
  memory     = HBM bytes/dev / HBM rate       (3.35 TB/s)
  collective = wire bytes/dev / NVLink rate   (450 GB/s a direction)

plus MODEL_FLOPS (6 N D to train, 2 N D to infer; N the active matmul
parameters, the head in and the embedding out, experts at top_k / E) and the
usefulness ratio MODEL / traced FLOPs, which catches remat and replicated
work.  The dominant term is the bottleneck.  These are bounds from counted
work, not times measured on a card.

Usage: PYTHONPATH=src python -m repro_torch.launch.roofline [--json path] [--out path]
"""

from __future__ import annotations

import argparse
import json
import os
from typing import Dict

from torch._subclasses.fake_tensor import FakeTensorMode

from repro_torch.configs import get_config
from repro_torch.launch.specs import SHAPES
from repro_torch.models import Model

PEAK_FLOPS = 989e12     # bf16 dense, H100 SXM (NVIDIA H100 data sheet)
HBM_BW = 3.35e12        # bytes/s, H100 SXM HBM3 (NVIDIA H100 data sheet)
LINK_BW = 450e9         # bytes/s a direction, NVLink 4 (900 GB/s both ways; data sheet)

RESULTS_DIR = os.path.join(os.path.dirname(__file__), "..", "..", "..", "build", "dryrun")


def param_counts(arch: str) -> Dict[str, float]:
    """Total and active (per-token) parameter counts: the embedding counted
    in the total but not as a matmul, experts at top_k / E of their size."""
    cfg = get_config(arch)
    with FakeTensorMode():
        shapes = {n: p.shape for n, p in Model(cfg, device="cpu").named_parameters()}
    total = active = 0.0
    for path, shape in shapes.items():
        n = 1.0
        for d in shape:
            n *= d
        name = path.split(".")[-1]
        total += n
        if name == "embed":
            continue  # gather, not matmul
        if name.startswith("e_w"):
            active += n * cfg.top_k / max(cfg.num_experts, 1)
        else:
            active += n
    return {"total": total, "active_matmul": active}


def model_flops(arch: str, shape_name: str, chips: int) -> float:
    """Per-device MODEL_FLOPS of the cell."""
    shape = SHAPES[shape_name]
    n_act = param_counts(arch)["active_matmul"]
    if shape.kind == "train":
        return 6.0 * n_act * shape.global_batch * shape.seq_len / chips
    if shape.kind == "prefill":
        return 2.0 * n_act * shape.global_batch * shape.seq_len / chips
    # decode: one token per sequence
    return 2.0 * n_act * shape.global_batch / chips


def _advice(dom: str) -> str:
    return {
        "compute": "raise MFU: fuse small ops, widen per-device batch, or cut "
                   "remat recompute",
        "memory": "cut HBM traffic: fuse norms / residuals / the optimizer's "
                  "elementwise passes, keep bf16 boundaries (weight-streaming bound "
                  "at decode)",
        "collective": "cut wire bytes: bf16 collectives, sequence-parallel TP "
                      "(reduce-scatter instead of all-reduce), or overlap "
                      "parameter gathers with compute",
    }[dom]


def analyze(dryrun_json: str, chips: int = 256) -> Dict[str, dict]:
    with open(dryrun_json) as f:
        cells = json.load(f)
    out: Dict[str, dict] = {}
    for key, res in sorted(cells.items()):
        if res.get("status") != "ok":
            out[key] = {"status": res.get("status", "missing"),
                        "reason": res.get("reason") or res.get("error", "")[:200]}
            continue
        arch, shape = key.split("|")
        prof = res["hlo_profile"]
        t_compute = prof["flops_per_device"] / PEAK_FLOPS
        t_memory = prof.get("hbm_bytes_per_device", 0.0) / HBM_BW
        t_coll = prof["collective_bytes_per_device"] / LINK_BW
        terms = {"compute": t_compute, "memory": t_memory, "collective": t_coll}
        dom = max(terms, key=terms.get)
        mf = model_flops(arch, shape, chips)
        bound = max(terms.values())
        out[key] = {
            "status": "ok",
            "compute_s": t_compute,
            "memory_s": t_memory,
            "collective_s": t_coll,
            "dominant": dom,
            "model_flops_per_device": mf,
            "useful_ratio": mf / prof["flops_per_device"] if prof["flops_per_device"] else 0.0,
            "roofline_fraction": t_compute / bound if bound > 0 else 0.0,
            "peak_gib": res["memory"]["peak_bytes"] / 2**30,
            "advice": _advice(dom),
        }
    return out


def to_markdown(table: Dict[str, dict]) -> str:
    lines = [
        "| cell | compute (s) | memory (s) | collective (s) | dominant | "
        "MODEL/traced | roofline frac | peak |",
        "|---|---|---|---|---|---|---|---|",
    ]
    for key, row in table.items():
        if row.get("status") != "ok":
            lines.append(f"| {key} | — | — | — | {row.get('status')} "
                         f"| — | — | {row.get('reason', '')[:60]} |")
            continue
        lines.append(
            f"| {key} | {row['compute_s']:.3f} | {row['memory_s']:.3f} | "
            f"{row['collective_s']:.3f} | **{row['dominant']}** | "
            f"{row['useful_ratio']:.2f} | {row['roofline_fraction']:.2f} | "
            f"{row['peak_gib']:.1f} GiB |")
    return "\n".join(lines)


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--json", default=os.path.join(RESULTS_DIR, "dryrun_single.json"))
    ap.add_argument("--out", default=None, help="default: roofline.json beside --json")
    ap.add_argument("--chips", type=int, default=256)
    args = ap.parse_args(argv)
    table = analyze(args.json, args.chips)
    out = args.out or os.path.join(os.path.dirname(os.path.abspath(args.json)), "roofline.json")
    with open(out, "w") as f:
        json.dump(table, f, indent=1)
    print(to_markdown(table))
    print(f"\nwritten: {out}")


if __name__ == "__main__":
    main()
