"""The benchmark's own data generator: a configuration's tables, made on the
device from ``--seed``.

A configuration names its tables (``"tables"``) and gives each table's row
count (``"<table>_rows"``) and columns (``"<table>_columns"``).  Each column
names its stored ``dtype`` and a distribution, ``"dist"``: the module
``pilotbench/dists/<dist>.py``, found by that name, whose ``make(spec, ctx)``
returns the column's values.  Columns are drawn in file order from one
``torch.Generator`` on the device, so a column may be derived from those
before it.  A column whose name starts with ``_`` is drawn and used but not
stored.  ``"<table>_sort_by"``, if given, names a column by which the rows
are then put in order (a table clustered on it).  ``"<table>_register"``,
if given, holds the keyword arguments of the program's
``Session.register_table`` for the table (dictionaries, a staged ladder,
shards), as data.
"""

from __future__ import annotations

import importlib
import re
from types import SimpleNamespace
from typing import Dict

import torch

DTYPES = {"int8": torch.int8, "int32": torch.int32, "int64": torch.int64,
          "float32": torch.float32}
_NAME = re.compile(r"^[a-z][a-z0-9_]*$")


def dist(name: str):
    """The distribution module ``pilotbench.dists.<name>``."""
    if not _NAME.match(name):
        raise ValueError(f"bad distribution name {name!r}")
    return importlib.import_module(f"pilotbench.dists.{name}")


def generator(seed: int, device) -> torch.Generator:
    g = torch.Generator(device=device)
    g.manual_seed(int(seed) % (1 << 63))
    return g


def make_columns(spec: Dict[str, dict], rows: int, g: torch.Generator, device,
                 config: dict) -> Dict[str, torch.Tensor]:
    cols: Dict[str, torch.Tensor] = {}
    for name, c in spec.items():
        ctx = SimpleNamespace(rows=rows, g=g, device=device, cols=cols, config=config)
        v = dist(c["dist"]).make(c, ctx)
        if tuple(v.shape) != (rows,):
            raise ValueError(f"column {name!r}: shape {tuple(v.shape)}, want ({rows},)")
        cols[name] = v.to(DTYPES[c["dtype"]]).contiguous()
    return {n: v for n, v in cols.items() if not n.startswith("_")}


def make_tables(config: dict, seed: int, device) -> Dict[str, Dict[str, torch.Tensor]]:
    """Every table of ``config`` as {table: {column: tensor}} on ``device``;
    a table's row count must be a whole number of blocks."""
    g = generator(seed, device)
    out = {}
    for t in config["tables"]:
        rows = int(config[f"{t}_rows"])
        if rows % int(config["block_rows"]):
            raise ValueError(f"{t}: {rows} rows is not a whole number of "
                             f"blocks of {config['block_rows']}")
        cols = make_columns(config[f"{t}_columns"], rows, g, device, config)
        key = config.get(f"{t}_sort_by")
        if key is not None:
            order = torch.argsort(cols[key], stable=True)
            cols = {n: v[order] for n, v in cols.items()}
        out[t] = cols
    return out


def register_options(config: dict, table: str) -> dict:
    """The keyword arguments of ``Session.register_table`` for ``table``."""
    return dict(config.get(f"{table}_register", {}))


def column_bytes(config: dict, table: str, column: str) -> int:
    """Bytes a row of a stored column takes."""
    dt = DTYPES[config[f"{table}_columns"][column]["dtype"]]
    return torch.empty((), dtype=dt).element_size()
