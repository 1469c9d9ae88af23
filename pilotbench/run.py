"""Run one cell of the benchmark once and print its result line.

    python3 pilotbench/run.py --workload <name> --seed <n> --seconds <s> --trace <0|1>

Run from the root of a checkout: the harness and the port it measures
(``src/repro_torch``) are found beside this file.  Set-up makes the cell's
tables on the card from the seed, builds or loads the port's kernels under
``build/`` in the checkout and warms the cell's queries; the window runs the
cell's traffic for ``--seconds``; then every answer is held against the
plain reference.  The last line of standard output is one JSON object
(``correct``, ``attempted``, ``failed``, ``metrics``, ``device``, with
``--trace 1`` also ``breakdown``; ``checks`` last); the numbers compared are
also the last lines of standard error.  Exits non-zero, printing no result,
without enough CUDA devices, where the port cannot be imported, or when the
process holds JAX or the JAX package once the window has closed.
"""

import time

T_PROCESS = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CACHE = os.path.join(ROOT, "build", "pilotbench")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    # every cache of the run at a fixed path inside the checkout
    for var, sub in (("TORCH_EXTENSIONS_DIR", "torch_extensions"),
                     ("TRITON_CACHE_DIR", "triton"),
                     ("TORCHINDUCTOR_CACHE_DIR", "inductor")):
        os.environ[var] = os.path.join(CACHE, sub)
    # one process with few threads, on a fixed pair of cores: the host
    # clock's work stays on the same cores for the whole run
    for var in ("OMP_NUM_THREADS", "MKL_NUM_THREADS", "OPENBLAS_NUM_THREADS"):
        os.environ[var] = "1"
    cores = sorted(os.sched_getaffinity(0))
    os.sched_setaffinity(0, cores[-2:])
    # the package by its full name, and no module of this folder at top level
    here = os.path.dirname(os.path.abspath(__file__))
    sys.path[:] = [ROOT, os.path.join(ROOT, "src")] + [
        p for p in sys.path if os.path.abspath(p or ".") != here]

    import torch
    from pilotbench import harness

    torch.set_num_threads(1)

    cell = harness.load_cell(args.workload)
    chips = int(cell.entry["chips"])
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"pilotbench: {chips} CUDA device(s) needed, "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0} found",
              file=sys.stderr)
        return 2
    result = harness.run_cell(args.workload, args.seed, args.seconds,
                              bool(args.trace), t_process=T_PROCESS, cell=cell).result
    bad = harness.forbidden_modules()
    if bad:
        print(f"pilotbench: the process holds {', '.join(bad)}", file=sys.stderr)
        return 3
    for name, c in result["checks"].items():
        print(f"check {name} {c['value']!r} limit {c['limit']!r} "
              f"over {c['answers']} answers", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
