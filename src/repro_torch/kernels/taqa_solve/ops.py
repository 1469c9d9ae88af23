"""Wrappers of the taqa_solve CUDA kernels (``csrc/taqa_solve.cu``): the
fused TAQA path's f32 rate solve, and its final Bernoulli draw with an
ordered stream compaction.

A CUDA tensor launches the hand-written kernel, or raises; a CPU tensor runs
the plain PyTorch version (``ref.py``).  The tensors' device alone decides:
there is no mode switch and no fallback.  Neither wrapper synchronises: the
outputs stay on the card for the next launch of the fused program.
"""

from __future__ import annotations

import threading
from typing import Dict, Tuple

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.taqa_solve.ref import taqa_draw_compact_ref, taqa_solve_rate_ref

MAX_SOLVE = 64       # solve channels one call takes (csrc kMaxSolve)
DRAW_THREADS = 1024  # the compaction's CTA, one row of a tile (csrc kDrawThreads)
TILE_ROWS = 16       # rows of a tile (csrc kTileRows)
TILE = DRAW_THREADS * TILE_ROWS  # uniforms per CTA of the compaction (csrc kTile)
MAX_UNIFORMS = 2 ** 31 - 1  # ids travel as int32
# the compaction's scratch (csrc 2 + kMaxTiles): epoch and ticket, the wrap
# launch's done count, one status word per tile of the largest call
SCRATCH_WORDS = 2 + -(-MAX_UNIFORMS // TILE)

_scratch_lock = threading.Lock()
_scratch: Dict[Tuple[int, int], torch.Tensor] = {}


def _draw_scratch(dev: torch.device, stream: int) -> torch.Tensor:
    """The compaction's scratch of (device, stream), made at its first use
    (1 MiB; the one fill): epoch 1, ticket 0, no status published.  Each
    launch advances the epoch on the card and leaves the ticket at zero;
    launches on one stream never overlap, and PyTorch's streams live as long
    as the process, so a key is never another stream's."""
    key = (dev.index, stream)
    with _scratch_lock:
        buf = _scratch.get(key)
        if buf is None:
            buf = torch.zeros(SCRATCH_WORDS, dtype=torch.int64)
            buf[0] = 1 << 32
            buf = _scratch[key] = buf.to(dev)
        return buf


def _on(t: torch.Tensor, dev: torch.device, dtype, shape, what: str) -> None:
    if (t.device != dev or t.dtype != dtype or tuple(t.shape) != tuple(shape)
            or not t.is_contiguous()):
        raise ValueError(f"{what} must be a contiguous {dtype} tensor of shape "
                         f"{tuple(shape)} on {dev}, got {t.dtype} "
                         f"{tuple(t.shape)} on {t.device}")


def taqa_solve_rate(block_sums: torch.Tensor, present: torch.Tensor, n_real: int,
                    channels: torch.Tensor, solve: torch.Tensor,
                    scal: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """The BSAP final-rate solve of one ungrouped pilot, in f32.

    ``block_sums`` (n_phys, n_ch) f32 holds the pilot's per-block channel
    sums, zero past ``n_real`` (a host int); ``present`` its (1,) bool group
    presence; ``channels`` (n_solve,) int32 the solve channels; ``solve``
    (n_solve, 5) f32 rows [t_q, chi_q, z, z_bin, e] and ``scal`` (6,) f32
    [N, max_rate, min_rate, cost_a, cost_b, exact_cost], the host's quantiles
    and cost line.  Returns ``theta`` (2,) f32 [theta, theta_eff] (theta_eff
    is 0 where the plan does not go) and ``flags`` (1,) int32: 1 no groups |
    2 a lower bound L_mu not positive and finite | 4 no feasible plan
    cheaper than exact.  The same bits on either device."""
    dev = block_sums.device
    if block_sums.dim() != 2:
        raise ValueError(f"block_sums must be (n_phys, n_ch), got {tuple(block_sums.shape)}")
    n_phys, n_ch = block_sums.shape
    n_solve = channels.shape[0] if channels.dim() == 1 else -1
    _on(block_sums, dev, torch.float32, (n_phys, n_ch), "block_sums")
    _on(present, dev, torch.bool, (1,), "present")
    _on(channels, dev, torch.int32, (n_solve,), "channels")
    _on(solve, dev, torch.float32, (n_solve, 5), "solve")
    _on(scal, dev, torch.float32, (6,), "scal")
    if not 1 <= n_solve <= MAX_SOLVE or n_ch < 1:
        raise ValueError(f"1 to {MAX_SOLVE} solve channels over >= 1 channel, "
                         f"got {n_solve} over {n_ch}")
    if not 0 <= n_real <= n_phys:
        raise ValueError(f"n_real {n_real} outside [0, {n_phys}]")
    _build.count(taqa_solve_rate, "calls")
    if dev.type == "cpu":
        return taqa_solve_rate_ref(block_sums, present, n_real, channels, solve, scal)
    if dev.type != "cuda":
        raise ValueError(f"taqa_solve_rate runs on cuda or cpu, not {dev}")
    lib = _build.load("taqa_solve")
    theta = torch.empty(2, dtype=torch.float32, device=dev)
    flags = torch.empty(1, dtype=torch.int32, device=dev)
    with torch.cuda.device(dev):
        rc = lib.taqa_solve_rate_launch(
            block_sums.data_ptr(), n_phys, n_ch, present.data_ptr(), n_real,
            channels.data_ptr(), n_solve, solve.data_ptr(), scal.data_ptr(),
            theta.data_ptr(), flags.data_ptr(), torch.cuda.current_stream(dev).cuda_stream)
    _build.check(lib, "taqa_solve", rc)
    _build.count(taqa_solve_rate, "launches")
    return theta, flags


def taqa_draw_compact(u: torch.Tensor,
                      theta_eff: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """The final block draw of a fused query: ``keep = u < theta_eff`` over
    the (N,) f32 uniforms, ``theta_eff`` a (1,) f32 tensor on the same
    device (read there, so no host sync).  Returns ``nsel`` (1,) int32 and
    ``padded`` (N,) int32: the kept indices in ascending order, zero past
    nsel — ``sampling.pad_block_ids``'s padding of the same draw.  The same
    bits on either device and run to run."""
    dev = u.device
    n = u.shape[0] if u.dim() == 1 else -1
    _on(u, dev, torch.float32, (n,), "u")
    _on(theta_eff, dev, torch.float32, (1,), "theta_eff")
    if n > MAX_UNIFORMS:
        raise ValueError(f"{n} uniforms, at most {MAX_UNIFORMS}")
    _build.count(taqa_draw_compact, "calls")
    if dev.type == "cpu":
        return taqa_draw_compact_ref(u, theta_eff)
    if dev.type != "cuda":
        raise ValueError(f"taqa_draw_compact runs on cuda or cpu, not {dev}")
    padded = torch.empty(n, dtype=torch.int32, device=dev)
    if n == 0:
        return torch.zeros(1, dtype=torch.int32, device=dev), padded
    nsel = torch.empty(1, dtype=torch.int32, device=dev)  # the last tile writes it
    lib = _build.load("taqa_solve")
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = lib.taqa_draw_compact_launch(
            u.data_ptr(), n, theta_eff.data_ptr(), _draw_scratch(dev, stream).data_ptr(),
            padded.data_ptr(), nsel.data_ptr(), stream)
    _build.check(lib, "taqa_solve", rc)
    _build.count(taqa_draw_compact, "launches")
    return nsel, padded


# ``calls`` counts every call on either device; ``launches`` counts CUDA
# launches only: one per call, each one kernel launch (the compaction is
# one single-pass launch).  Plain integers, bumped under ``_build.count``'s
# lock: a run resets and reads them.
taqa_solve_rate.calls = 0
taqa_solve_rate.launches = 0
taqa_draw_compact.calls = 0
taqa_draw_compact.launches = 0
