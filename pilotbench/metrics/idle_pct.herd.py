"""idle_pct.herd: idle_pct in a cell of refreshes."""

from pilotbench.metrics import idle_pct


def read(ctx):
    return idle_pct(ctx) if ctx.mix["mode"] == "refresh" else None
