"""numpy mirrors of segment_sum's sort-free CUDA routes (``kernels/
segment_sum/csrc/segment_sum.cu``): the slab and few kernels' f32 additions
in the kernels' own order.  The CPU tests hold them to the plain version and
an f64 sum; the card tests hold the kernels to them bit for bit.  Imports
numpy and the port's planning functions only, so it runs where JAX is
absent."""

import numpy as np

from repro_torch.kernels.segment_sum import ops as segment_ops
from repro_torch.kernels.segment_sum.ops import range_rows


def _butterfly(lanes):
    """warp_sum of block_reduce.cuh over the last axis (32 lanes), f32."""
    v = np.asarray(lanes, np.float32)
    o = 16
    while o:
        v = (v + v[..., np.arange(32) ^ o]).astype(np.float32)
        o >>= 1
    return v[..., 0]


def _step_sums(vals, seg, lo, hi, key_lo, key_hi):
    """One warp's walk over rows [lo, hi) in steps of 32 (csrc walk_steps):
    in each step, each distinct key in [key_lo, key_hi), in the order of its
    lowest lane, gets the butterfly of its rows' values (the other lanes
    giving 0), added to the key's running f32 sum in step order.  Returns
    {key: (C,) f32}."""
    c_n = vals.shape[0]
    sums = {}
    for p0 in range(lo, hi, 32):
        r = np.arange(p0, min(p0 + 32, hi))
        k = np.full(32, -1, np.int64)
        k[: r.size] = seg[r]
        k[(k < key_lo) | (k >= key_hi)] = -1
        v = np.zeros((c_n, 32), np.float32)
        v[:, : r.size] = vals[:, r]
        _, first_lane = np.unique(k, return_index=True)
        for key in k[np.sort(first_lane)]:
            if key < 0:
                continue
            t = _butterfly(np.where(k == key, v, np.float32(0.0)))
            sums[key] = (sums.get(key, np.zeros(c_n, np.float32)) + t).astype(np.float32)
    return sums


def mirror_slab(vals, seg, num_segments, slab_rows, slab_keys):
    """The slab route: one warp per slab of ``slab_rows`` rows walks its
    rows and writes the keys [slab * W, slab * W + W) (the lane form holds
    them from 0, the wide form adds into a zero-filled output: the same
    sums in the same order)."""
    c_n, rows = vals.shape
    out = np.zeros((c_n, num_segments), np.float32)
    for b in range(-(-rows // slab_rows)):
        base = b * slab_keys
        for key, t in _step_sums(vals, seg, b * slab_rows, min((b + 1) * slab_rows, rows),
                                 base, min(base + slab_keys, num_segments)).items():
            out[:, key] = t
    return out


def _range_sum(part):
    """The range pass: per output, thread t of 256 adds ranges t, t + 256,
    ... in order, then the butterfly in each of 8 warps and over the 8 warp
    sums (lanes 8.. giving 0)."""
    acc = np.zeros((part.shape[0], 256), np.float32)
    for i0 in range(0, part.shape[1], 256):
        chunk = part[:, i0:i0 + 256]
        acc[:, : chunk.shape[1]] = (acc[:, : chunk.shape[1]] + chunk).astype(np.float32)
    warps = _butterfly(acc.reshape(part.shape[0], 8, 32))
    return _butterfly(np.concatenate([warps, np.zeros((part.shape[0], 24), np.float32)], 1))


def mirror_few(vals, seg, num_segments):
    """The few route: ranges of ``range_rows(R)`` rows, one warp each.  For
    S <= 4 lane l adds rows l, l + 32, ... of its range into its slot of the
    row's key, then the butterfly per key and channel; for a larger S the
    warp walks its range as the slab route does, into S * C slots from 0.
    Then the range pass.  Returns (out, range partials)."""
    c_n, rows = vals.shape
    rr = range_rows(rows)
    ranges = -(-rows // rr)
    part = np.zeros((c_n, num_segments, ranges), np.float32)
    for g in range(ranges):
        lo, hi = g * rr, min((g + 1) * rr, rows)
        if num_segments <= segment_ops.LANE_KEYS:
            acc = np.zeros((32, num_segments, c_n), np.float32)
            for p0 in range(lo, hi, 32):
                r = p0 + np.arange(32)
                ok = r < hi
                k = np.where(ok, seg[np.minimum(r, hi - 1)], -1)
                for s_ in range(num_segments):
                    m = ok & (k == s_)
                    acc[m, s_] = (acc[m, s_] + vals[:, r[m]].T).astype(np.float32)
            part[:, :, g] = _butterfly(acc.transpose(2, 1, 0))
        else:
            for key, t in _step_sums(vals, seg, lo, hi, 0, num_segments).items():
                part[:, key, g] = t
    part = part.reshape(c_n * num_segments, ranges)
    return _range_sum(part).reshape(c_n, num_segments), part


def slab_keys(rng, rows, slab_rows, width, num_segments, scratch_from):
    """Keys that keep the slab claim: row r's key is r // slab_rows * W plus
    a draw in [0, W); rows from ``scratch_from`` on carry a key past the
    last segment (the pilot's scratch rows), and a few rows a negative
    one."""
    seg = (np.arange(rows) // slab_rows) * width + rng.integers(0, width, rows)
    seg[scratch_from:] = num_segments + rng.integers(0, width, rows - scratch_from)
    seg[rng.integers(0, rows, 5)] = -1
    return seg
