"""Serving CLI: batched requests through the slot engine, on the card.

  python -m repro_torch.launch.serve --arch rwkv6-7b --reduced \
      --requests 8 --max-new 16
  python -m repro_torch.launch.serve --arch hymba-1.5b --reduced --device cpu

The reference's ``launch/serve.py`` with ``--device`` (``cuda`` by default;
raises without a card unless ``cpu`` is asked for).  The weights are random,
drawn from ``--seed`` on the device; prompts of 2–7 tokens from the same
seed.
"""

from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from repro_torch.configs import get_config
from repro_torch.device import resolve_device
from repro_torch.models import Model
from repro_torch.serve.engine import ServeEngine


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="internlm2-1.8b")
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--requests", type=int, default=8)
    ap.add_argument("--slots", type=int, default=4)
    ap.add_argument("--cache-len", type=int, default=128)
    ap.add_argument("--max-new", type=int, default=16)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    cfg = get_config(args.arch)
    if args.reduced:
        cfg = cfg.reduced()
    dev = resolve_device(args.device)
    model = Model(cfg, device=dev).init(torch.Generator(device=dev).manual_seed(args.seed))
    engine = ServeEngine(model, batch_slots=args.slots, cache_len=args.cache_len,
                         seed=args.seed)

    rng = np.random.default_rng(args.seed)
    t0 = time.perf_counter()
    ids = []
    for _ in range(args.requests):
        prompt = rng.integers(0, cfg.vocab_size, rng.integers(2, 8)).tolist()
        ids.append(engine.submit(prompt, max_new_tokens=args.max_new))
    out = engine.run()
    dt = time.perf_counter() - t0
    tokens = sum(len(v) for v in out.values())
    print(f"served {len(out)}/{args.requests} requests, {tokens} tokens in "
          f"{dt:.2f}s ({tokens / dt:.1f} tok/s, {engine.steps} engine steps, "
          f"{args.slots} slots, {dev})")
    for rid in ids[:3]:
        print(f"  req {rid}: {out[rid]}")
    return out


if __name__ == "__main__":
    main()
