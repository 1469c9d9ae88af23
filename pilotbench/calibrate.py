"""Readings for the limits of the comparison: the program's numbers and the
control's, on several seeds of one cell, in one process.

    python3 pilotbench/calibrate.py --workload <name> --seeds 1,2,3 --seconds 10

For each seed the cell runs as ``run.py`` runs it, with a window of
``--seconds``.  The control is then the reference computed in bfloat16, the
precision below the configurations' float32, put in the program's place
(:func:`pilotbench.check.control_answers`) and judged as the program's
answers are.  Prints one JSON line a seed: ``checks`` (the program) and
``control_checks`` (the control), which has to come out as not correct.
The benchmark's own runs never run the control.
"""

import time

T_PROCESS = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def control_checks(outcome, dtype):
    """The control's numbers: the reference in ``dtype`` in the program's
    place, over every table of the catalog and, for an approximate answer,
    over the blocks of every table its final sampled; judged against the
    float64 reference."""
    from pilotbench import check
    ref = outcome.reference
    low = check.Reference(ref.tables, ref.block_rows, dtype=dtype)
    return check.judge(check.control_answers(outcome.answers, low), ref, outcome.limits)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--seconds", type=float, default=10.0)
    args = ap.parse_args(argv)
    here = os.path.dirname(os.path.abspath(__file__))
    sys.path[:] = [ROOT, os.path.join(ROOT, "src")] + [
        p for p in sys.path if os.path.abspath(p or ".") != here]
    import torch
    from pilotbench import check, harness

    if not torch.cuda.is_available():
        print("calibrate: no CUDA device", file=sys.stderr)
        return 2
    cell = harness.load_cell(args.workload)
    for seed in (int(s) for s in args.seeds.split(",")):
        t0 = time.perf_counter()
        out = harness.run_cell(args.workload, seed, args.seconds, False,
                               t_process=t0, cell=cell)
        line = {"workload": args.workload, "seed": seed,
                "correct": out.result["correct"], "attempted": out.result["attempted"],
                "metrics": out.result["metrics"], "checks": out.result["checks"]}
        ctl = control_checks(out, torch.bfloat16)
        line.update(control_checks=ctl, control_correct=check.passed(ctl))
        line["seconds"] = time.perf_counter() - t0
        print(json.dumps(line), flush=True)
        del out
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
