"""Multi-pod dry run of the port: the reference's ``launch/dryrun.py`` on a
fake world of 256 or 512 ranks.

For every (architecture x input shape) cell on a production mesh:

  1. inside :func:`mesh.fake_world` (a ``"fake"`` process group, the
     counterpart of the reference's 512 placeholder devices) and under
     ``FakeTensorMode`` (its ``ShapeDtypeStruct`` lowering: nothing is
     allocated, no kernel runs), build the model and the AdamW state on
     fake ``--device`` tensors;
  2. shard them by ``train.sharding``: the parameters and moments by
     ``params_shardings``, the batch by ``batch_pspecs``, the caches by
     ``cache_pspecs``, with the reference's ``shard_hints``;
  3. trace one ``make_train_step`` step (``microbatches`` as the
     reference's), ``prefill`` or ``decode_step`` under
     :class:`trace_analysis.TraceAnalysis` and :class:`PeakBytes`;
  4. record per device: ``argument_bytes`` (the local shards of state and
     inputs, exact from their placements), ``output_bytes`` (the local
     shards of what the call returns), ``peak_bytes`` (the high-water mark
     of live fake storage, by :class:`PeakBytes`, a dispatch mode of this
     module, with the arguments live from the start), and the
     ``hlo_profile`` keys of ``trace_analysis``.

The reference's ``cost_analysis`` (XLA's own count, loop bodies once) has
no counterpart here and is left out.  A cell that ``cell_supported``
refuses is ``skipped`` with its reason; one that raises is ``failed`` with
the traceback.  Results go to ``build/dryrun/dryrun_<mesh>[_opt].json``
(``arch|shape`` keys) after every cell, so a partial run is useful.

Usage:
  PYTHONPATH=src python -m repro_torch.launch.dryrun --mesh single --arch all --shape all
  PYTHONPATH=src python -m repro_torch.launch.dryrun --device cpu --reduced \\
      --mesh-shape 4,2 --arch hymba-1.5b --shape train_4k
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import time
import traceback
import weakref
from typing import Any, Dict, Optional

import numpy as np
import torch
from torch.distributed.device_mesh import init_device_mesh
from torch.distributed.tensor import DTensor
from torch.utils._python_dispatch import TorchDispatchMode

from repro_torch.configs import get_config, list_architectures
from repro_torch.launch.mesh import fake_world, make_production_mesh
from repro_torch.launch.specs import SHAPES, ShapeSpec, batch_specs, cell_supported, decode_specs
from repro_torch.launch.trace_analysis import TraceAnalysis, in_sharding_propagation
from repro_torch.models import Model
from repro_torch.train import sharding as shd
from repro_torch.train.optimizer import AdamWConfig, init_opt_state
from repro_torch.train.step import TrainState, make_train_step

RESULTS_DIR = os.path.join(os.path.dirname(__file__), "..", "..", "..", "build", "dryrun")


def _local(t: torch.Tensor) -> torch.Tensor:
    return t.to_local() if isinstance(t, DTensor) else t


def _leaves(tree):
    return [t for t in torch.utils._pytree.tree_flatten(tree)[0] if isinstance(t, torch.Tensor)]


def local_bytes(tree) -> int:
    """Bytes of this rank's shards of every tensor in ``tree``, each storage
    once."""
    seen, total = set(), 0
    for t in _leaves(tree):
        st = _local(t).untyped_storage()
        if id(st) not in seen:
            seen.add(id(st))
            total += st.nbytes()
    return total


class PeakBytes(TorchDispatchMode):
    """The high-water mark of live storage bytes on this rank: the storages
    of ``live`` at the start, then every storage an op (on local shards:
    the mode steps aside for DTensor) creates, until it is freed."""

    def __init__(self, live=()):
        super().__init__()
        self.bytes = self.peak = 0
        self._live: Dict[int, int] = {}
        for t in _leaves(live):
            self._track(_local(t))

    def _track(self, t: torch.Tensor) -> None:
        st = t.untyped_storage()
        key = id(st)
        if key in self._live:
            return
        n = st.nbytes()
        self._live[key] = n
        self.bytes += n
        self.peak = max(self.peak, self.bytes)
        weakref.finalize(st, self._free, key)

    def _free(self, key: int) -> None:
        self.bytes -= self._live.pop(key, 0)

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        if any(issubclass(t, DTensor) for t in types):
            return NotImplemented
        out = func(*args, **(kwargs or {}))
        if not in_sharding_propagation():
            for t in _leaves(out):
                self._track(t)
        return out


def opt_overrides(cfg, shape: ShapeSpec) -> Dict[str, Any]:
    """The reference's beyond-baseline levers (``dryrun.py:77-98``): sub-block
    GLA for SSM / hybrid, dense-all-experts MoE to train, token-chunked MoE
    to prefill, two-level remat for deep / wide dense configs."""
    over: Dict[str, Any] = {}
    if cfg.has_ssm:
        over["gla_impl"] = "subblock"
    if cfg.is_moe and shape.kind == "train":
        over["moe_dense_train"] = True
    if cfg.is_moe and shape.kind == "prefill":
        over["moe_chunk"] = 16384
    if cfg.num_layers * cfg.d_model >= 52 * 6144:  # deep/wide dense
        for g in (8, 6, 4, 2):
            if cfg.num_layers % g == 0:
                over["remat_groups"] = g
                break
    return over


def data_parallel(mesh) -> int:
    n = 1
    for a in shd.data_axes(mesh):
        n *= shd.axis_sizes(mesh)[a]
    return n


def microbatches(shape: ShapeSpec, mesh) -> int:
    """Sequence-level microbatching, as the reference's: one sequence per
    device a microbatch."""
    return max(shape.global_batch // max(data_parallel(mesh), 1), 1)


def shard_hints(cfg, shape: ShapeSpec, mesh, variant: str) -> Dict[str, Any]:
    """The reference's hints: batch on the data axes when it divides;
    sequence-parallel only for hybrid training in the opt variant."""
    tp = shd.tp_axis(mesh)
    return {"dp": shd.data_axes(mesh), "tp": tp,
            "dp_ok": shape.global_batch % max(data_parallel(mesh), 1) == 0,
            "sp": (variant == "opt" and cfg.family == "hybrid" and shape.kind == "train"
                   and shape.seq_len % shd.axis_sizes(mesh)[tp or "model"] == 0)}


def _zeros(spec, device) -> torch.Tensor:
    shape, dtype = spec
    return torch.zeros(shape, dtype=dtype, device=device)


def build_cell(cfg, shape: ShapeSpec, mesh, variant: str, device: str):
    """(fn, args, params) of the cell on ``mesh``: the model with the
    reference's hints, sharded by ``train.sharding``, the call and its
    sharded inputs (the train step and its state and batch; the prefill and
    its batch; a decode step and its cache and token), on ``device``, the
    parameters left as allocated.  Built under a fake mode, nothing is
    allocated."""
    model = Model(cfg, device=device)
    model.shard_hints = shard_hints(cfg, shape, mesh, variant)
    if shape.kind == "train":
        model.requires_grad_(True)
    shd.shard_model(model, mesh)
    params = dict(model.named_parameters())
    if shape.kind == "train":
        batch = shd.place_batch({k: _zeros(v, device) for k, v in batch_specs(cfg, shape).items()},
                                mesh)
        fn = make_train_step(model, AdamWConfig(), microbatches=microbatches(shape, mesh))
        return fn, (TrainState(params, init_opt_state(params), None), batch), params
    if shape.kind == "prefill":
        batch = shd.place_batch({k: _zeros(v, device) for k, v in batch_specs(cfg, shape).items()},
                                mesh)
        return (lambda b: model.prefill(b, cache_len=shape.seq_len)), (batch,), params
    token_spec, _ = decode_specs(cfg, shape)
    cache = model.init_cache(shape.global_batch, shape.seq_len)
    token = shd.place_batch({"token": _zeros(token_spec, device)}, mesh)["token"]
    return model.decode_step, (cache, token), params


def _trace(cfg, shape: ShapeSpec, mesh, variant: str, device: str) -> Dict[str, Any]:
    """One fake trace of the cell at ``cfg`` and ``shape`` as given: its
    per-device numbers, flat, and its seconds."""
    # the state is built under the fake mode; the trace runs outside it, each
    # fake tensor's op entering its mode (DTensor's own bookkeeping, index
    # arithmetic on small tensors, stays real), and a real tensor an op meets
    # (a position vector) is taken in as a fake one
    with torch._subclasses.fake_tensor.FakeTensorMode(allow_non_fake_inputs=True):
        fn, args, params = build_cell(cfg, shape, mesh, variant, device)
        live = (params, args)
        argument_bytes = local_bytes(live)
    t0 = time.perf_counter()
    with torch.device(device), PeakBytes(live) as peak, TraceAnalysis(mesh.size()) as trace:
        out = fn(*args)
    prof = trace.result()
    return {"trace_s": time.perf_counter() - t0, "argument_bytes": argument_bytes,
            "output_bytes": local_bytes(out), "peak_bytes": peak.peak,
            **{k: prof[k] for k in ("flops_per_device", "hbm_bytes_per_device",
                                    "collective_bytes_per_device")},
            **{f"count:{k}": v for k, v in prof["collective_counts"].items()},
            **{f"bytes:{k}": v for k, v in prof["collective_bytes_by_kind"].items()}}


def _depths(cfg) -> Dict[str, int]:
    """The config's repeated stacks and the unit each is cut in: layers (in
    remat groups when there are groups), and an encoder's layers."""
    G = cfg.remat_groups if cfg.remat_groups > 1 and cfg.num_layers % cfg.remat_groups == 0 else 1
    units = {"num_layers": G}
    if cfg.family == "encdec":
        units["encoder_layers"] = 1
    return units


def lower_cell(arch: str, shape_name: str, mesh, variant: str = "baseline", *,
               device: str = "cuda", cfg=None, shape: Optional[ShapeSpec] = None) -> Dict[str, Any]:
    """One cell on ``mesh`` (inside a world of its size).  ``cfg`` and
    ``shape`` override the registry's (a cut depth, a host-sized batch).

    A training cell deeper than two units of each stack, or of more than
    three microbatches, is not traced whole: layers and microbatches repeat,
    each running the same ops at the same shapes, so (as the reference
    compiles one scanned layer) it is traced at the cut depths (1 and 2
    units a stack) and at 2 and 3 microbatches of its own size, and each
    count (FLOPs, bytes, collectives) is the fit ``a + sum_i b_i d_i + m (c
    + sum_i e_i d_i)`` (d_i the depths, m the microbatches) at the cell's
    own, exact for a decoder stack (an encoder-decoder's cross terms make
    it approximate).  The peak is no such line (its moment moves with the
    depth), so it comes from one more trace at the full depth and 2
    microbatches (every microbatch after the first repeats the first's
    live set).  ``traced`` lists the points.  Other cells are traced as
    they are."""
    cfg = cfg if cfg is not None else get_config(arch)
    shape = shape if shape is not None else SHAPES[shape_name]
    ok, reason = cell_supported(cfg, shape)
    if not ok:
        return {"status": "skipped", "reason": reason}
    if variant == "opt":
        cfg = dataclasses.replace(cfg, **opt_overrides(cfg, shape))

    units = _depths(cfg)
    m_real = microbatches(shape, mesh) if shape.kind == "train" else 1
    full = {v: getattr(cfg, v) for v in units}
    t0 = time.perf_counter()
    rows_per_mb = shape.global_batch // m_real
    if shape.kind != "train" or (all(full[v] <= 2 * u for v, u in units.items())
                                 and m_real <= 3):
        points = [(full, m_real)]
    else:
        base = dict(units)
        depth_points = [base] + [{**base, v: 2 * u} for v, u in units.items()]
        ms = (2, 3) if m_real >= 2 else (1,)
        points = [(d, m) for m in ms for d in depth_points]
    trace = lambda depths, m: _trace(dataclasses.replace(cfg, **depths),
                                     dataclasses.replace(shape, global_batch=rows_per_mb * m),
                                     mesh, variant, device)
    rows = [trace(d, m) for d, m in points]
    keys = sorted({k for r in rows for k in r if k != "trace_s"})
    if len(points) == 1:
        num = {k: float(rows[0].get(k, 0)) for k in keys}
    else:
        # exact bilinear fit: columns 1, d_i, m, m d_i
        design = lambda d, m: [1.0, *[float(d[v]) for v in units], float(m),
                               *[float(m * d[v]) for v in units]]
        a = np.array([design(d, m) for d, m in points])
        if len(set(m for _, m in points)) == 1:
            a = a[:, :1 + len(units)]
        at = np.array(design(full, m_real))[:a.shape[1]]
        num = {}
        for k in keys:
            coef = np.linalg.solve(a, np.array([float(r.get(k, 0)) for r in rows]))
            num[k] = float(at @ coef)
        points.append((full, min(m_real, 2)))
        num["peak_bytes"] = float(trace(*points[-1])["peak_bytes"])
    exact = lambda x: int(round(x))
    return {
        "status": "ok",
        "trace_s": time.perf_counter() - t0,
        "traced": [{**d, "microbatches": m} for d, m in points],
        "memory": {"argument_bytes": exact(num["argument_bytes"]),
                   "output_bytes": exact(num["output_bytes"]),
                   "peak_bytes": exact(num["peak_bytes"])},
        "hlo_profile": {
            "flops_per_device": num["flops_per_device"],
            "hbm_bytes_per_device": num["hbm_bytes_per_device"],
            "collective_bytes_per_device": num["collective_bytes_per_device"],
            "collective_counts": {k[6:]: exact(v) for k, v in num.items()
                                  if k.startswith("count:") and exact(v)},
            "collective_bytes_by_kind": {k[6:]: v for k, v in num.items()
                                         if k.startswith("bytes:") and exact(v)},
            "num_partitions": mesh.size(),
        },
    }


def _mesh(args):
    """(world size, mesh factory) of the CLI's choice."""
    if args.mesh_shape:
        d, m = (int(x) for x in args.mesh_shape.split(","))
        return d * m, lambda: init_device_mesh(args.device, (d, m),
                                               mesh_dim_names=("data", "model"))
    multi = args.mesh == "multi"
    return (512 if multi else 256), lambda: make_production_mesh(multi_pod=multi,
                                                                 device_type=args.device)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--mesh", choices=["single", "multi"], default="single")
    ap.add_argument("--arch", default="all")
    ap.add_argument("--shape", default="all")
    ap.add_argument("--variant", choices=["baseline", "opt"], default="baseline")
    ap.add_argument("--out", default=None)
    ap.add_argument("--device", default="cuda",
                    help="the fake tensors' device: cuda (the card's kernels' checks), or cpu")
    ap.add_argument("--reduced", action="store_true", help="each arch's .reduced() config")
    ap.add_argument("--mesh-shape", default=None,
                    help="a (data, model) mesh 'D,M' on a fake world of D*M ranks, "
                         "in place of --mesh's production mesh")
    args = ap.parse_args(argv)

    archs = list_architectures() if args.arch == "all" else [args.arch]
    shapes = list(SHAPES) if args.shape == "all" else [args.shape]
    tag = args.mesh_shape.replace(",", "x") if args.mesh_shape else args.mesh
    suffix = "" if args.variant == "baseline" else f"_{args.variant}"
    out_path = args.out or os.path.join(RESULTS_DIR, f"dryrun_{tag}{suffix}.json")
    os.makedirs(os.path.dirname(os.path.abspath(out_path)), exist_ok=True)
    results: Dict[str, Any] = {}
    if os.path.exists(out_path):
        with open(out_path) as f:
            results = json.load(f)

    world, make = _mesh(args)
    failures = 0
    with fake_world(world):
        mesh = make()
        for arch in archs:
            cfg = get_config(arch).reduced() if args.reduced else get_config(arch)
            for shape in shapes:
                key = f"{arch}|{shape}"
                if results.get(key, {}).get("status") in ("ok", "skipped"):
                    print(f"[cached] {key}: {results[key]['status']}")
                    continue
                print(f"[dryrun:{tag}] {key} ...", flush=True)
                try:
                    res = lower_cell(arch, shape, mesh, variant=args.variant,
                                     device=args.device, cfg=cfg)
                except Exception as e:  # noqa: BLE001 -- failures are the signal
                    res = {"status": "failed", "error": f"{type(e).__name__}: {e}",
                           "traceback": traceback.format_exc()[-2000:]}
                    failures += 1
                results[key] = res
                with open(out_path, "w") as f:
                    json.dump(results, f, indent=1)
                if res["status"] == "ok":
                    m, p = res["memory"], res["hlo_profile"]
                    print(f"  ok: trace={res['trace_s']:.2f}s "
                          f"args={m['argument_bytes'] / 2**30:.3f}GiB "
                          f"peak={m['peak_bytes'] / 2**30:.3f}GiB "
                          f"flops/dev={p['flops_per_device']:.3e} "
                          f"coll/dev={p['collective_bytes_per_device'] / 2**30:.3f}GiB",
                          flush=True)
                else:
                    print(f"  {res['status']}: {res.get('reason') or res.get('error')}",
                          flush=True)
    print(f"done; {failures} failures -> {out_path}")
    return 1 if failures else 0


if __name__ == "__main__":
    raise SystemExit(main())
