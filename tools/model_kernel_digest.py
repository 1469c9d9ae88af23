#!/usr/bin/env python3
"""Print a SHA-256 digest of the model kernels' forward outputs and of the
flash backward's gradients on seeded inputs, so that two checkouts can be
held to each other bit for bit on one card.

    python3 tools/model_kernel_digest.py [--src DIR]

``DIR`` is the ``src`` directory whose ``repro_torch`` to load (default:
this checkout's).  Only the public wrappers are called, under
``torch.no_grad()`` (the inference route, with no log-sum-exp asked for):
``flash_attention`` at hymba's (2, 25, 2048, 64) window 1024 and
internlm2's (2, 16, 4096, 128) causal, a ragged (1, 6, 201, 128) over 333
keys non-causal and a (1, 4, 65, 64) causal, in bf16 and f32;
``gla_chunked`` (o and the final state) at (2, 25, 2048, 16 / 64), (1, 64,
2048, 64 / 64) and (1, 3, 130, 16 / 64) with decays past the -8 clamp, in
bf16 and f32; then dq, dk and dv of the flash backward kernels (the
wrapper's ``ops._forward`` with the log-sum-exp, then ``ops._backward``
with an output gradient drawn from the same seed) at the same flash inputs
in bf16 and f32 and at the reduced configs' (8, 4, 64, 16) causal in f32
(bf16 d 256, gemma-7b's, is left out).  Prints one line per wrapper,
``<name> <calls> <sha256>`` (the backward as ``flash_attention_bwd``), then
``all <sha256>``.  Equal lines from two checkouts mean bitwise equal
outputs.  Needs a CUDA card.
"""

import argparse
import hashlib
import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--src", default=os.path.join(ROOT, "src"))
    src = os.path.abspath(ap.parse_args().src)
    import numpy as np
    import torch
    if not torch.cuda.is_available():
        print("model_kernel_digest: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, src)
    from repro_torch.kernels.flash_attn import flash_attention
    from repro_torch.kernels.flash_attn import ops as flash_ops
    from repro_torch.kernels.gla_chunk import gla_chunked

    dev = torch.device("cuda")
    digests = {"flash_attention": hashlib.sha256(), "gla_chunked": hashlib.sha256(),
               "flash_attention_bwd": hashlib.sha256()}
    calls = dict.fromkeys(digests, 0)

    def add(name, *outs):
        torch.cuda.synchronize()
        for out in outs:
            digests[name].update(out.contiguous().view(torch.uint8).cpu().numpy().tobytes())
        calls[name] += 1

    def normal(rng, shape, dtype, scale=1.0):
        a = (rng.standard_normal(shape) * scale).astype(np.float32)
        return torch.from_numpy(a).to(dev).to(dtype)

    flash = [((2, 25, 5, 2048, 2048, 64), True, 1024), ((2, 16, 8, 4096, 4096, 128), True, 0),
             ((1, 6, 2, 201, 333, 128), False, 0), ((1, 4, 2, 65, 65, 64), True, 0)]
    gla = [(2, 25, 2048, 16), (1, 64, 2048, 64), (1, 3, 130, 16)]
    with torch.no_grad():
        for dtype in (torch.bfloat16, torch.float32):
            for (b, hq, hkv, sq, skv, d), causal, window in flash:
                rng = np.random.default_rng(sq + d)
                q = normal(rng, (b, hq, sq, d), dtype)
                k, v = (normal(rng, (b, hkv, skv, d), dtype) for _ in range(2))
                add("flash_attention", flash_attention(q, k, v, causal=causal, window=window))
            for b, h, t, dk in gla:
                rng = np.random.default_rng(t + dk)
                q, k = normal(rng, (b, h, t, dk), dtype, 0.5), normal(rng, (b, h, t, dk), dtype, 0.5)
                v = normal(rng, (b, h, t, 64), dtype)
                g = torch.from_numpy(-rng.uniform(0.0, 0.3, (b, h, t, dk)).astype(np.float32))
                g[..., :3, :] = -9.0
                add("gla_chunked", *gla_chunked(q, k, v, g.to(dev).to(dtype)))
    reduced = [((8, 4, 2, 64, 64, 16), True, 0)]
    for dtype in (torch.bfloat16, torch.float32):
        for (b, hq, hkv, sq, skv, d), causal, window in flash + (
                reduced if dtype == torch.float32 else []):
            rng = np.random.default_rng(sq + d + 1)
            q = normal(rng, (b, hq, sq, d), dtype)
            k, v = (normal(rng, (b, hkv, skv, d), dtype) for _ in range(2))
            do = normal(rng, (b, hq, sq, d), dtype)
            scale = 1.0 / d ** 0.5
            o, lse = flash_ops._forward(q, k, v, causal, window, scale, True)
            add("flash_attention_bwd",
                *flash_ops._backward(q, k, v, o, lse, do, causal, window, scale))
    total = hashlib.sha256()
    for name, h in digests.items():
        print(f"{name} {calls[name]} {h.hexdigest()}")
        total.update(h.digest())
    print(f"all {total.hexdigest()}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
