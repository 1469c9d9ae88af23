"""Guaranteed-error approximate evaluation of a language model on the
PyTorch/CUDA port: the paper's technique applied to an eval corpus (see
``src/repro_torch/aqpeval/``), the model's forward on the card through the
hand-written flash_attn and gla_chunk kernels.

    python examples/torch_approx_eval.py                    # hymba-1.5b, the card
    python examples/torch_approx_eval.py --device cpu --reduced --shards 32 --seq 48

A shard is ``bsz`` sequences of ``seq + 1`` tokens; its metric is the summed
next-token NLL (log_softmax in f32 over every padded vocab column) and its
count ``bsz * seq``, as in ``examples/approx_eval.py``.  The weights are
random, drawn from ``--seed``: the repository holds no checkpoint.
"""

import argparse
import os
import sys
import time

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)), "..", "src"))

import numpy as np
import torch

from repro_torch.aqpeval import GuaranteedEvaluator
from repro_torch.configs import get_config
from repro_torch.models import Model


def shard_loss(model: Model, tokens: torch.Tensor) -> torch.Tensor:
    """Summed next-token NLL of ``tokens`` (bsz, seq + 1): f32 scalar."""
    logits, _ = model({"tokens": tokens[:, :-1]})
    lp = torch.log_softmax(logits.float(), dim=-1)
    return -lp.gather(-1, tokens[:, 1:, None]).sum()


def make_block_metric(model: Model, shards: np.ndarray):
    """``block_metric(ids) -> (sums, counts)`` over ``shards`` (n, bsz, seq
    + 1) for :class:`GuaranteedEvaluator`: one forward per requested shard,
    on the model's device, under ``torch.inference_mode()``.  The returned
    dict counts the shards evaluated."""
    _, bsz, seq1 = shards.shape
    device = model.embed.device
    calls = {"shards": 0}

    @torch.inference_mode()
    def block_metric(ids):
        calls["shards"] += len(ids)
        sums = np.array([float(shard_loss(model, torch.from_numpy(shards[i]).to(device)))
                         for i in ids])
        return sums, np.full(len(ids), bsz * (seq1 - 1), float)

    return block_metric, calls


def eval_corpus(vocab_size: int, shards: int, bsz: int, seq: int, seed: int = 1) -> np.ndarray:
    """Random token shards (shards, bsz, seq + 1) from ``seed``."""
    return np.random.default_rng(seed).integers(0, vocab_size, (shards, bsz, seq + 1))


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--arch", default="hymba-1.5b")
    ap.add_argument("--reduced", action="store_true",
                    help="the architecture's small same-family config")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--shards", type=int, default=128)
    ap.add_argument("--bsz", type=int, default=2)
    ap.add_argument("--seq", type=int, default=2048)
    ap.add_argument("--seed", type=int, default=0, help="weights")
    ap.add_argument("--error", type=float, default=0.05)
    ap.add_argument("--confidence", type=float, default=0.9)
    ap.add_argument("--pilot-blocks", type=int, default=16)
    args = ap.parse_args(argv)

    cfg = get_config(args.arch)
    if args.reduced:
        cfg = cfg.reduced()
    model = Model(cfg, args.device)
    gen = torch.Generator(device=model.embed.device).manual_seed(args.seed)
    model.init(gen)
    shards = eval_corpus(cfg.vocab_size, args.shards, args.bsz, args.seq)
    block_metric, calls = make_block_metric(model, shards)

    t0 = time.perf_counter()
    res = GuaranteedEvaluator(args.shards, block_metric, seed=3).evaluate(
        error=args.error, confidence=args.confidence, pilot_blocks=args.pilot_blocks)
    approx_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    s, c = block_metric(np.arange(args.shards))
    exact_s = time.perf_counter() - t0
    truth = s.sum() / c.sum()
    print(f"{cfg.name} on {model.embed.device}: {args.shards} shards of "
          f"{args.bsz} x {args.seq} tokens")
    print(f"approx eval loss : {res.estimate:.4f}  (<={args.error:.0%} error "
          f"w.p. {args.confidence:.0%}), {approx_s:.2f} s")
    print(f"exact eval loss  : {truth:.4f}  (achieved "
          f"{abs(res.estimate - truth) / truth:.2%}), {exact_s:.2f} s")
    print(f"model calls      : {res.pilot_blocks + res.final_blocks}/{res.total_blocks} "
          f"shards ({res.blocks_saved_frac:.0%} of eval compute saved), "
          f"theta {res.theta:.4f}, exact fallback {res.exact}")


if __name__ == "__main__":
    main()
