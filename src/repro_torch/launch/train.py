"""End-to-end training driver of the port: the reference's
``launch/train.py`` on the card.

Wires the runtime together: config registry, the AQP-planned data mixture
(the port's PilotDB on the device), AdamW, microbatch accumulation, optional
int8 error-feedback gradient compression, checkpoint/restart in the
reference's layout (+ SIGTERM emergency save), the straggler watchdog, and a
guaranteed-error approximate evaluation of the trained model.

  python -m repro_torch.launch.train --arch internlm2-1.8b --steps 10 \\
      --batch 2 --seq 4096 --aqp-mixture --approx-eval
  python -m repro_torch.launch.train --reduced --device cpu --steps 50 \\
      --batch 8 --seq 64 --ckpt-dir /tmp/ck

The reference's flags, plus ``--device`` (``cuda`` by default; raises
without a card unless ``cpu`` is asked for).  The weights are random, drawn
from ``--seed`` on the device.  There is no ``jit``: a step runs eagerly,
and reading its loss is its one wait for the card.  Returns the losses.
"""

from __future__ import annotations

import argparse
import os

import numpy as np
import torch

from repro_torch.aqpeval import GuaranteedEvaluator
from repro_torch.configs import get_config
from repro_torch.device import resolve_device
from repro_torch.models import Model
from repro_torch.train import checkpoint as ckpt
from repro_torch.train.data import TokenPipeline, make_domain_metadata, plan_mixture_weights
from repro_torch.train.elastic import StragglerWatchdog
from repro_torch.train.optimizer import AdamWConfig
from repro_torch.train.step import init_train_state, make_train_step


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="internlm2-1.8b")
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--steps", type=int, default=50)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=64)
    ap.add_argument("--lr", type=float, default=3e-3)
    ap.add_argument("--microbatches", type=int, default=1)
    ap.add_argument("--compress-grads", action="store_true")
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--ckpt-every", type=int, default=20)
    ap.add_argument("--resume", action="store_true")
    ap.add_argument("--aqp-mixture", action="store_true",
                    help="plan the data mixture with a guaranteed-error AQP query")
    ap.add_argument("--approx-eval", action="store_true",
                    help="finish with a guaranteed-error approximate eval")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    cfg = get_config(args.arch)
    if args.reduced:
        cfg = cfg.reduced()
    dev = resolve_device(args.device)
    model = Model(cfg, device=dev)

    # ---- data (optionally AQP-planned mixture) ------------------------------
    domains = {"default": 1.0}
    if args.aqp_mixture:
        meta = make_domain_metadata({"web": 2000, "code": 1000, "books": 1000},
                                    block_rows=64, seed=args.seed, device=dev)
        weights, report = plan_mixture_weights(meta, 3, error=0.1, confidence=0.9,
                                               seed=args.seed)
        names = ["books", "code", "web"]
        domains = {names[g]: w for g, w in weights.items()}
        frac = (report.pilot_scanned_bytes + report.final_scanned_bytes) \
            / max(report.exact_scanned_bytes, 1)
        print(f"[aqp-mixture] weights={domains} "
              f"(scanned {frac:.1%} of metadata, fallback={report.fallback})")
    pipe = TokenPipeline(cfg.vocab_size, args.batch, args.seq,
                         domains=domains, seed=args.seed)

    # ---- state / resume ------------------------------------------------------
    opt_cfg = AdamWConfig(lr=args.lr, warmup_steps=max(args.steps // 10, 1),
                          total_steps=args.steps, weight_decay=0.0)
    state = init_train_state(model, torch.Generator(device=dev).manual_seed(args.seed),
                             compress=args.compress_grads)
    start_step = 0
    saver = None
    if args.ckpt_dir:
        os.makedirs(args.ckpt_dir, exist_ok=True)
        saver = ckpt.EmergencySaver(args.ckpt_dir)
        if args.resume:
            latest = ckpt.latest_step(args.ckpt_dir)
            if latest is not None:
                state, extra = ckpt.restore(args.ckpt_dir, latest, state)
                start_step = extra.get("step", latest)
                pipe.state.step = extra.get("data_step", start_step)
                print(f"[resume] from step {start_step}")

    step_fn = make_train_step(model, opt_cfg, microbatches=args.microbatches,
                              compress=args.compress_grads)
    watchdog = StragglerWatchdog()

    losses = []
    try:
        for step in range(start_step, args.steps):
            batch = {k: torch.from_numpy(v).to(dev) for k, v in pipe.next_batch().items()}
            watchdog.start()
            state, metrics = step_fn(state, batch)
            loss = float(metrics["loss"])  # waits for the step; makes the timing honest
            slow = watchdog.stop()
            losses.append(loss)
            if slow:
                print(f"[watchdog] step {step} straggled "
                      f"(remesh advised: {watchdog.should_remesh})")
            if step % 10 == 0 or step == args.steps - 1:
                print(f"step {step:5d} loss {loss:.4f} "
                      f"gnorm {float(metrics['grad_norm']):.3f} "
                      f"lr {float(metrics['lr']):.2e}")
            if args.ckpt_dir and (step + 1) % args.ckpt_every == 0:
                ckpt.save(args.ckpt_dir, step + 1, state,
                          extra={"step": step + 1, "data_step": pipe.state.step})
            if saver is not None:
                saver.maybe_save(step + 1, state)
    finally:
        if saver is not None:
            saver.close()

    # ---- guaranteed-error approximate eval -----------------------------------
    if args.approx_eval:
        rng = np.random.default_rng(args.seed + 1)
        n_blocks = 64
        shards = rng.integers(0, cfg.vocab_size,
                              (n_blocks, 2, args.seq + 1), dtype=np.int32)

        @torch.no_grad()
        def shard_loss(tokens):
            logits, _ = model({"tokens": tokens[:, :-1]})
            lp = torch.log_softmax(logits.float(), dim=-1)
            nll = -lp.gather(-1, tokens[:, 1:, None].long())
            return nll.sum()

        def block_metric(ids):
            sums = np.array([float(shard_loss(torch.from_numpy(shards[i]).to(dev)))
                             for i in ids])
            return sums, np.full(len(ids), 2 * args.seq, float)

        ev = GuaranteedEvaluator(n_blocks, block_metric, seed=args.seed)
        res = ev.evaluate(error=0.05, confidence=0.9, pilot_blocks=12)
        print(f"[approx-eval] loss≈{res.estimate:.4f} ±5% @90% "
              f"(evaluated {res.pilot_blocks + res.final_blocks}/{res.total_blocks} "
              f"blocks, saved {res.blocks_saved_frac:.0%})")

    print(f"final loss {losses[-1]:.4f} (from {losses[0]:.4f}); "
          f"stragglers={len(watchdog.slow_steps)}")
    return losses


if __name__ == "__main__":
    main()
