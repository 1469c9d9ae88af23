"""Batched LLM requests on the PyTorch/CUDA port: slot-based continuous
batching (``repro_torch.serve.ServeEngine``) over ``Model.decode_step``.

    python examples/torch_serve_llm.py                        # the card
    python examples/torch_serve_llm.py --device cpu --reduced

Serves rwkv6 (attention-free, an O(1) state per sequence), internlm2 (GQA
attention over a KV cache), hymba (a sliding-window ring beside an SSM
state) and granite-moe (experts routed densely at decode), each through the
same engine.  Full-width configs unless ``--reduced``; random weights drawn
from ``--seed``: the repository holds no checkpoint.
"""

import argparse
import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)), "..", "src"))

from repro_torch.launch.serve import main as serve_main

ARCHS = {
    "rwkv6-7b": "attention-free, O(1) state",
    "internlm2-1.8b": "GQA attention, KV cache",
    "hymba-1.5b": "sliding-window ring + SSM state",
    "granite-moe-1b-a400m": "32 experts, top-8, dense decode route",
}


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--reduced", action="store_true",
                    help="each architecture's small same-family config")
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)
    for arch, what in ARCHS.items():
        print(f"== {arch} ({what}) ==")
        serve_main(["--arch", arch, "--requests", "6", "--slots", "3",
                    "--max-new", "12", "--device", args.device,
                    "--seed", str(args.seed)] + (["--reduced"] if args.reduced else []))


if __name__ == "__main__":
    main()
