"""``tpch_sparse_key``: dbgen's sparse order key (``mk_sparse``, 8 keys used
of every 32) of the parent index ``of`` + 1 (dbgen counts orders from 1)."""


def make(spec, ctx):
    i = ctx.cols[spec["of"]].long() + 1
    return ((i >> 3) << 5) | (i & 7)
