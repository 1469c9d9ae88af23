"""The plain reference: TPC-H query families answered in plain PyTorch.

Each family is a module of this package (``q6.py``, ``q1.py``, ...) that
holds the SQL template the traffic fills in and the same query's meaning
over the raw columns:

* ``TABLE`` -- the table it reads, the fact table that the pilot samples;
* ``JOINS`` -- optional: left-deep equi joins from ``TABLE``, each
  ``(table, left key, right key)`` on a key that is unique in the right
  table; ``COLUMNS`` may then name columns of any joined table, and a fact
  row whose key finds no match drops out;
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

:func:`exact_sums` evaluates a family over a whole catalog,
``{table: {column: tensor}}``, and :func:`sample_sums` over the rows whose
every sampled table's block was drawn, in any dtype: float64 for the
reference, bfloat16 for the control that the benchmark's comparison has to
reject.  A joined table's columns are gathered at each fact row's key
through a key-to-row map built by scatter (TPC-H keys are dense integers).
Nothing here imports the program under test.
"""

from __future__ import annotations

import importlib
import math
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


def joins(fam) -> Tuple[Tuple[str, str, str], ...]:
    """The family's joins, ``()`` for a family of one table."""
    return tuple(getattr(fam, "JOINS", ()))


def tables_of(fam) -> Tuple[str, ...]:
    """The tables a family reads: the fact table, then each joined table."""
    return (fam.TABLE,) + tuple(t for t, _, _ in joins(fam))


def _names(fam) -> set:
    return set(fam.COLUMNS) | ({fam.GROUP_BY} if fam.GROUP_BY else set())


def _num_rows(cols: Dict[str, torch.Tensor]) -> int:
    return int(next(iter(cols.values())).shape[0])


def _row_chunks(num_rows: int, device):
    """A table's row indices, ``CHUNK_ROWS`` at a time."""
    return (torch.arange(lo, min(lo + CHUNK_ROWS, num_rows), device=device)
            for lo in range(0, num_rows, CHUNK_ROWS))


def exact_sums(catalog: Dict[str, Dict[str, torch.Tensor]], fam,
               params_list: Sequence[Dict[str, object]],
               dtype=torch.float64) -> List[np.ndarray]:
    """Channel sums (channels, groups) over every row of the family's fact
    table, joined through its ``JOINS``, one per entry of ``params_list``,
    accumulated chunk by chunk in ``dtype``."""
    cols = catalog[fam.TABLE]
    num_rows = _num_rows(cols)
    phs = [fam.placeholders(p) for p in params_list]
    if joins(fam):
        dev = next(iter(cols.values())).device
        return _joined_sums(catalog, fam, phs, _row_chunks(num_rows, dev), dtype)
    names = _names(fam)
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


def sample_sums(catalog: Dict[str, Dict[str, torch.Tensor]], block_rows: int,
                fam, params: Dict[str, object], block_ids: Dict[str, object],
                dtype=torch.float64) -> np.ndarray:
    """Channel sums (channels, groups) over the rows of the sample:
    ``block_ids`` holds the drawn block ids of each sampled table, and a
    (joined) row counts when the block it comes from in every sampled table
    was drawn.  Rows past a table's end are padding and count for nothing."""
    other = set(block_ids) - set(tables_of(fam))
    if other:
        raise ValueError(f"{fam.__name__} reads no table {sorted(other)}")
    cols = catalog[fam.TABLE]
    num_rows = _num_rows(cols)
    dev = next(iter(cols.values())).device
    ph = fam.placeholders(params)
    if fam.TABLE in block_ids:
        idx = block_rows_index(block_ids[fam.TABLE], block_rows, dev)
        idx = idx[idx < num_rows]
    if not joins(fam):
        chunk = {c: cols[c][idx] for c in _names(fam)}
        values = _channel_values(fam, chunk, dtype)
        return _channel_sums(fam, chunk, values, ph, dtype).double().cpu().numpy()
    if fam.TABLE in block_ids:
        chunks = (idx[lo:lo + CHUNK_ROWS] for lo in range(0, idx.numel(), CHUNK_ROWS))
    else:
        chunks = _row_chunks(num_rows, dev)
    drawn = {}
    for t, ids in block_ids.items():
        if t != fam.TABLE:
            drawn[t] = torch.zeros(-(-_num_rows(catalog[t]) // block_rows),
                                   dtype=torch.bool, device=dev)
            drawn[t][torch.as_tensor(np.asarray(ids, dtype=np.int64), device=dev)] = True
    (sums,) = _joined_sums(catalog, fam, [ph], chunks, dtype, drawn, block_rows)
    return sums


def key_map(keys: torch.Tensor) -> torch.Tensor:
    """The row that holds each key 0..max(keys) of a key column, -1 where
    none does; raises where a key is negative or held by two rows."""
    k = keys.long()
    if int(k.min()) < 0:
        raise ValueError("a join key is negative")
    rows = torch.arange(k.numel(), device=k.device)
    at = torch.full((int(k.max()) + 1,), -1, dtype=torch.int64, device=k.device)
    at[k] = rows
    if not torch.equal(at[k], rows):
        raise ValueError("a join's right key is not unique")
    return at


def _lookup(at: torch.Tensor, key: torch.Tensor) -> torch.Tensor:
    """``at`` read at each key, -1 where the key lies outside it."""
    key = key.long()
    inside = (key >= 0) & (key < at.numel())
    return torch.where(inside, at[key.clamp(0, at.numel() - 1)], torch.full_like(key, -1))


def _join(catalog, fam, idx: torch.Tensor, maps: Dict[str, torch.Tensor],
          drawn: Dict[str, torch.Tensor], block_rows: int) -> Dict[str, torch.Tensor]:
    """The family's columns at the fact rows ``idx``, each joined to its
    match in every table of ``JOINS``: only the rows that find a match in
    each, and whose block in each table of ``drawn`` was drawn."""
    rows = {fam.TABLE: idx}

    def holder(col):
        return next(t for t in rows if col in catalog[t])

    for table, left_key, right_key in joins(fam):
        t = holder(left_key)
        at = _lookup(maps[table], catalog[t][left_key][rows[t]])
        keep = at >= 0
        rows = {u: r[keep] for u, r in rows.items()}
        rows[table] = at[keep]
    for table, mask in drawn.items():
        keep = mask[rows[table] // block_rows]
        rows = {u: r[keep] for u, r in rows.items()}
    return {c: catalog[holder(c)][c][rows[holder(c)]] for c in _names(fam)}


def _joined_sums(catalog, fam, phs, chunks, dtype, drawn=None,
                 block_rows: int = 1) -> List[np.ndarray]:
    """Channel sums, one per placeholder set of ``phs``, over the joined
    rows of each chunk of fact rows, accumulated in ``dtype``."""
    maps = {t: key_map(catalog[t][right_key]) for t, _, right_key in joins(fam)}
    acc = [None] * len(phs)
    for idx in chunks:
        chunk = _join(catalog, fam, idx, maps, drawn or {}, block_rows)
        values = _channel_values(fam, chunk, dtype)
        for i, ph in enumerate(phs):
            s = _channel_sums(fam, chunk, values, ph, dtype)
            acc[i] = s if acc[i] is None else acc[i] + s
    return [a.double().cpu().numpy() for a in acc]


def sample_scale(draws: Sequence[Tuple[float, int, int]]) -> float:
    """The scale of a sample's sums, from each sampled table's ``(rate, N
    blocks, n blocks drawn)``, as the paper's final rewriting (§3.3) scales
    them.  Each table's blocks are drawn on their own, each kept with its
    table's rate θ, so a joined row is in the sample with probability ∏θ:

    * one sampled table: N / n, the estimator conditional on the sample's
      size;
    * two or more: Horvitz-Thompson, every row weighted by 1 / ∏θ, from the
      sample's own rates.
    """
    if len(draws) == 1:
        _, n_total, n_sampled = draws[0]
        return n_total / n_sampled
    return 1.0 / math.prod(rate for rate, _, _ in draws)


def sample_answer(fam, sums: np.ndarray,
                  draws: Sequence[Tuple[float, int, int]]) -> Tuple[np.ndarray, np.ndarray]:
    """The estimate from one sample: each sum scaled by :func:`sample_scale`."""
    return compose(fam, sums, sample_scale(draws))


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
