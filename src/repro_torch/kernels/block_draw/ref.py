"""The plain version of the ``block_draw`` kernel (the CPU route and the
kernel's yardstick in tests), and the PCG64 arithmetic both share.

numpy's ``default_rng(seed)`` is PCG64: a 128-bit LCG ``s <- A s + inc (mod
2^128)`` whose uniform ``i`` is ``(xsl_rr(s_(i+1)) >> 11) * 2^-53``, with
``s_0`` and ``inc`` from the seed (:func:`pcg64_state`).  Any state is one
jump from the seed's: ``s_d = A^d s_0 + G_d inc`` with ``G_d = sum_(j<d)
A^j``, and ``(A^d, G_d)`` depend on no seed, so :func:`jump_table` holds them
for d = 2^k and a jump by d takes one multiply-add per set bit of d.

:func:`block_draw_ref` computes what the kernel computes, in its order: each
of its threads jumps to the first index of a chunk of :data:`CHUNK`
consecutive indices, then steps through the chunk.  The 128-bit products
wrap in numpy's uint64 (64-bit limbs), which PyTorch's signed integers do
not do portably.
"""

from __future__ import annotations

from typing import List, Tuple

import numpy as np
import torch

MULTIPLIER = 0x2360ED051FC65DA44385DF649FCCF645  # PCG's 128-bit LCG multiplier
MASK128 = (1 << 128) - 1
JUMPS = 32       # jumps by 2^0 ... 2^31: an index + 1 is at most 2^31 (csrc kJumps)
CHUNK = 16       # consecutive indices a thread draws (csrc kChunk)

_M32 = np.uint64(0xFFFFFFFF)


def jump_table(jumps: int = JUMPS) -> List[Tuple[int, int]]:
    """``(A^(2^k), G_(2^k)) mod 2^128`` for k < ``jumps``, where a jump by
    2^k takes any state s to ``A^(2^k) s + G_(2^k) inc``; G doubles as
    ``G_2m = G_m (1 + A^m)``."""
    out, a, g = [], MULTIPLIER, 1
    for _ in range(jumps):
        out.append((a, g))
        a, g = (a * a) & MASK128, (g * (1 + a)) & MASK128
    return out


def pcg64_state(seed) -> Tuple[int, int]:
    """``(state, inc)`` of ``np.random.default_rng(seed)``'s bit generator:
    numpy's own seeding, so every seed it takes gives its own stream and any
    it refuses raises here too."""
    st = np.random.PCG64(seed).state["state"]
    return int(st["state"]), int(st["inc"])


def jump(state: int, inc: int, d: int) -> int:
    """The state d steps after ``state``, by the table (Python integers)."""
    for k, (a, g) in enumerate(jump_table(max(d.bit_length(), 1))):
        if d >> k & 1:
            state = (a * state + g * inc) & MASK128
    return state


def xsl_rr(state: int) -> int:
    """PCG64's output of a state: the xor of its halves rotated right by its
    top six bits."""
    x = ((state >> 64) ^ state) & 0xFFFFFFFFFFFFFFFF
    r = state >> 122
    return ((x >> r) | (x << (64 - r))) & 0xFFFFFFFFFFFFFFFF


def uniform_at(state: int, inc: int, i: int) -> float:
    """Uniform ``i`` of the stream from ``(state, inc)``: what
    ``Generator(PCG64).random(n)[i]`` gives, with no uniform before it."""
    return (xsl_rr(jump(state, inc, i + 1)) >> 11) * 2.0 ** -53


# -- 128-bit arithmetic on (hi, lo) uint64 arrays, wrapping as the kernel's --

def _mulhi(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    """The high 64 bits of the 128-bit product of two uint64 arrays."""
    a0, a1, b0, b1 = a & _M32, a >> np.uint64(32), b & _M32, b >> np.uint64(32)
    p00, p01, p10, p11 = a0 * b0, a0 * b1, a1 * b0, a1 * b1
    mid = (p00 >> np.uint64(32)) + (p01 & _M32) + (p10 & _M32)
    return p11 + (p01 >> np.uint64(32)) + (p10 >> np.uint64(32)) + (mid >> np.uint64(32))


def _muladd(a: Tuple[np.ndarray, np.ndarray], s: Tuple[np.ndarray, np.ndarray],
            c: Tuple[np.ndarray, np.ndarray]) -> Tuple[np.ndarray, np.ndarray]:
    """``a * s + c mod 2^128`` on (hi, lo) pairs."""
    (ah, al), (sh, sl), (ch, cl) = a, s, c
    hi = _mulhi(al, sl) + al * sh + ah * sl
    lo = al * sl
    lo2 = lo + cl
    return hi + ch + (lo2 < lo).astype(np.uint64), lo2


def _pair(x: int) -> Tuple[np.ndarray, np.ndarray]:
    return np.uint64(x >> 64), np.uint64(x & 0xFFFFFFFFFFFFFFFF)


def block_draw_ref(num_blocks: int, rate: float, state: int,
                   inc: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """Same function as the ``block_draw`` kernel, on the CPU: ``(count (1,)
    int32, ids (num_blocks,) int32)``, the indices i with uniform i below
    ``rate`` (in f64) in ascending order, then zeros.  The kernel writes
    its zeros only up to the draw's padded length (``sampling.pad_block_ids``'s
    ``n_phys``) and leaves the rest of its output as it found it."""
    n = int(num_blocks)
    first = np.arange(0, n, CHUNK, dtype=np.uint64)
    hi0, lo0 = _pair(state)
    s = (np.full(first.shape, hi0), np.full(first.shape, lo0))
    with np.errstate(over="ignore"):
        d = first + np.uint64(1)
        for k, (a, g) in enumerate(jump_table()):
            bit = ((d >> np.uint64(k)) & np.uint64(1)) == 1
            if not bit.any():
                continue
            c = _muladd(_pair(g), _pair(inc), (np.uint64(0), np.uint64(0)))
            hi, lo = _muladd(_pair(a), s, c)
            s = (np.where(bit, hi, s[0]), np.where(bit, lo, s[1]))
        keep = np.zeros((len(first), CHUNK), bool)
        step, plus = _pair(MULTIPLIER), _pair(inc)
        for j in range(CHUNK):
            x = s[0] ^ s[1]
            rot = s[0] >> np.uint64(58)
            out = (x >> rot) | (x << ((np.uint64(64) - rot) & np.uint64(63)))
            keep[:, j] = (out >> np.uint64(11)).astype(np.float64) * 2.0 ** -53 < rate
            s = _muladd(step, s, plus)
    kept = np.nonzero(keep.reshape(-1)[:n])[0].astype(np.int32)
    ids = torch.zeros(n, dtype=torch.int32)
    ids[:len(kept)] = torch.from_numpy(kept)
    return torch.tensor([len(kept)], dtype=torch.int32), ids
