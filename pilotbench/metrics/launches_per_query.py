"""launches_per_query: device kernels in the traced window per query
answered in it (memory copies and sets not counted)."""


def read(ctx):
    if ctx.trace is None or not ctx.records:
        return None
    return sum(o.cat == "kernel" for o in ctx.trace.ops) / len(ctx.records)
