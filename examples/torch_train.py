"""Training on the PyTorch/CUDA port: ``repro_torch.launch.train`` with an
AQP-planned data mixture and a guaranteed-error approximate evaluation at
the end.

    python examples/torch_train.py                           # the card, full width
    python examples/torch_train.py --device cpu --reduced    # the CPU, a few seconds

On the card: internlm2-1.8b at full width (24 layers, d 2048, 1.89B
parameters, bf16), batch 2 x 4,096 tokens, through the flash-attention
kernels forward and backward.  ``--reduced`` takes the small same-family
config (2 layers, d 64, f32) at batch 8 x 64; on the CPU the kernels' plain
PyTorch versions run.  Random weights from ``--seed``.
"""

import argparse
import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)), "..", "src"))

from repro_torch.launch.train import main as train_main


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--reduced", action="store_true",
                    help="the small same-family config")
    ap.add_argument("--arch", default="internlm2-1.8b")
    ap.add_argument("--steps", type=int, default=10)
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)
    shape = ["--batch", "8", "--seq", "64"] if args.reduced else ["--batch", "2", "--seq", "4096"]
    return train_main(["--arch", args.arch, "--steps", str(args.steps), *shape,
                       "--aqp-mixture", "--approx-eval", "--device", args.device,
                       "--seed", str(args.seed)] + (["--reduced"] if args.reduced else []))


if __name__ == "__main__":
    main()
