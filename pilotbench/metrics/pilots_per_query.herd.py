"""pilots_per_query.herd: pilot stages run per query over the window's
refreshes (``DrainStats.pilots_run`` over ``DrainStats.n_queries``): what
the scheduler's pilot sharing saves."""


def read(ctx):
    n = sum(r["n_queries"] for r in ctx.refreshes)
    return sum(r["pilots_run"] for r in ctx.refreshes) / n if n else None
