"""queries_per_s: queries answered in the window over the window's seconds
(from its start to the end of the last refresh, which may run past the
deadline)."""


def read(ctx):
    return len(ctx.records) / ctx.window_s if ctx.records else None
