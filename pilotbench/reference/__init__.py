"""The plain reference: TPC-H query families answered in plain PyTorch.

Each family is a module of this package (``q6.py``, ``q1.py``, ...) that
holds the SQL template the traffic fills in and the same query's meaning
over the raw columns:

* ``TABLE`` -- the one table it reads;
* ``SQL`` -- the dialect text, with ``{placeholders}``;
* ``placeholders(params)`` -- the template's values from the TPC-H
  substitution parameters a mix draws (``year``, ``discount``, ...);
* ``COLUMNS`` -- the columns the query reads (predicates and expressions);
* ``GROUP_BY`` / ``MAX_GROUPS`` -- the grouping column, or None and 1;
* ``CHANNELS`` -- the simple sums the composites are made of, in order:
  ``"count"`` or the name of a value expression;
* ``COMPOSITES`` -- ``(name, kind, channel indices)``, kind ``sum``,
  ``count``, ``avg`` or ``ratio``;
* ``mask(cols, ph)`` -- the rows' predicate on the stored columns;
* ``values(cols, cast)`` -- each value channel of the rows, through
  ``cast``.

:func:`exact_sums` evaluates a family over a whole table and
:func:`sample_sums` over the rows of given blocks, in any dtype: float64 for
the reference, bfloat16 for the control that the benchmark's comparison has
to reject.  Nothing here
imports the program under test.
"""

from __future__ import annotations

import importlib
import re
from typing import Dict, List, Sequence, Tuple

import numpy as np
import torch

_NAME = re.compile(r"^[a-z][a-z0-9_]*$")
CHUNK_ROWS = 1 << 25


def family(name: str):
    """The family module ``pilotbench.reference.<name>``."""
    if not _NAME.match(name):
        raise ValueError(f"bad family name {name!r}")
    return importlib.import_module(f"{__name__}.{name}")


def render(fam, params: Dict[str, object], guarantee) -> str:
    """The SQL text of one query: the template filled in, and the
    ``ERROR e% CONFIDENCE c%`` clause when ``guarantee`` is (e, c)."""
    text = fam.SQL.format(**fam.placeholders(params))
    if guarantee is not None:
        text += f" ERROR {guarantee[0]:g}% CONFIDENCE {guarantee[1]:g}%"
    return text


def _channel_values(fam, cols: Dict[str, torch.Tensor], dtype) -> torch.Tensor:
    """(channels, rows) values in ``dtype``; a count channel is ones."""
    vals = fam.values(cols, lambda t: t.to(dtype))
    rows = next(iter(cols.values())).shape[0]
    dev = next(iter(cols.values())).device
    return torch.stack([torch.ones(rows, dtype=dtype, device=dev) if ch == "count"
                        else vals[ch] for ch in fam.CHANNELS])


def _channel_sums(fam, cols: Dict[str, torch.Tensor], values: torch.Tensor, ph,
                  dtype) -> torch.Tensor:
    """(channels, groups) sums of ``values`` over the rows of ``cols`` that
    pass the predicate, group by group; each sum is one reduction in
    ``dtype`` (torch accumulates a bfloat16 one in float32)."""
    mask = fam.mask(cols, ph)
    if fam.GROUP_BY is None:
        masks = [mask]
    else:
        g = cols[fam.GROUP_BY]
        masks = [mask & (g == k) for k in range(fam.MAX_GROUPS)]
    return torch.stack([(values * m.to(dtype)).sum(dim=1) for m in masks], dim=1)


def compose(fam, sums: np.ndarray, scale: float = 1.0):
    """Composite values (composites, groups) and the groups present from
    channel sums (channels, groups), each sum scaled by ``scale``."""
    counts = sums[fam.CHANNELS.index("count")] if "count" in fam.CHANNELS else None
    out = np.full((len(fam.COMPOSITES), sums.shape[1]), np.nan)
    for k, (_, kind, idx) in enumerate(fam.COMPOSITES):
        if kind in ("sum", "count"):
            out[k] = sums[idx[0]] * scale
        else:  # avg, ratio: the scale cancels
            with np.errstate(invalid="ignore", divide="ignore"):
                out[k] = sums[idx[0]] / sums[idx[1]]
    present = (counts > 0) if counts is not None else np.ones(sums.shape[1], bool)
    return out, present


def exact_sums(cols: Dict[str, torch.Tensor], num_rows: int, fam,
               params_list: Sequence[Dict[str, object]],
               dtype=torch.float64) -> List[np.ndarray]:
    """Channel sums (channels, groups) over every row of the table, one per
    entry of ``params_list``, accumulated chunk by chunk in ``dtype``."""
    names = set(fam.COLUMNS) | ({fam.GROUP_BY} if fam.GROUP_BY else set())
    phs = [fam.placeholders(p) for p in params_list]
    acc = [None] * len(phs)
    for lo in range(0, num_rows, CHUNK_ROWS):
        chunk = {c: cols[c][lo:lo + CHUNK_ROWS] for c in names}
        values = _channel_values(fam, chunk, dtype)
        for i, ph in enumerate(phs):
            s = _channel_sums(fam, chunk, values, ph, dtype)
            acc[i] = s if acc[i] is None else acc[i] + s
    return [a.double().cpu().numpy() for a in acc]


def block_rows_index(block_ids, block_rows: int, device) -> torch.Tensor:
    ids = torch.as_tensor(np.asarray(block_ids, dtype=np.int64), device=device)
    return (ids[:, None] * block_rows
            + torch.arange(block_rows, device=device)[None, :]).reshape(-1)


def sample_sums(cols: Dict[str, torch.Tensor], num_rows: int, block_rows: int,
                fam, params: Dict[str, object], block_ids,
                dtype=torch.float64) -> np.ndarray:
    """Channel sums (channels, groups) over the rows of the given blocks
    (rows past ``num_rows`` are padding and count for nothing)."""
    names = set(fam.COLUMNS) | ({fam.GROUP_BY} if fam.GROUP_BY else set())
    dev = next(iter(cols.values())).device
    idx = block_rows_index(block_ids, block_rows, dev)
    idx = idx[idx < num_rows]
    chunk = {c: cols[c][idx] for c in names}
    values = _channel_values(fam, chunk, dtype)
    return _channel_sums(fam, chunk, values, fam.placeholders(params),
                         dtype).double().cpu().numpy()


def sample_answer(fam, sums: np.ndarray, n_total_blocks: int,
                  n_sampled_blocks: int) -> Tuple[np.ndarray, np.ndarray]:
    """The estimate from one block sample: each sum scaled by N / n (the
    estimator of a single sampled table, conditional on the sample size)."""
    return compose(fam, sums, n_total_blocks / n_sampled_blocks)


def relative_gap(got: np.ndarray, want: np.ndarray) -> float:
    """Largest |got - want| / |want| over the entries, inf where one side is
    NaN and the other is not."""
    got, want = np.asarray(got, float), np.asarray(want, float)
    if got.shape != want.shape:
        return float("inf")
    nan_g, nan_w = np.isnan(got), np.isnan(want)
    if (nan_g != nan_w).any():
        return float("inf")
    ok = ~nan_w
    if not ok.any():
        return 0.0
    den = np.maximum(np.abs(want[ok]), np.finfo(float).tiny)
    return float(np.max(np.abs(got[ok] - want[ok]) / den))


def tpch_days(year: int, month: int = 1) -> int:
    """Days from 1992-01-01 to the first of ``month`` in ``year`` (the
    generator's ``l_shipdate`` unit)."""
    import datetime
    return (datetime.date(year, month, 1) - datetime.date(1992, 1, 1)).days
