"""idle_pct: the share of the traced window in which no operation ran on
the card (1 - the union of the device intervals / the window)."""

from pilotbench.metrics import idle_pct


def read(ctx):
    return idle_pct(ctx) if ctx.mix["mode"] == "sql" else None
