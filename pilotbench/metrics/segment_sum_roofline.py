"""segment_sum_roofline: the share of the memory roofline that the
``segment_sum`` kernels reach over the window: per query, the rows that
pass its predicate among the rows each stage sums (every row for an exact
answer; the pilot's and the final's sampled rows of the fact table, times
its share of passing rows, for an approximate one), each with its value
channels and its int32 key in and one f32 sum a channel and group out, at
3.35 TB/s, over those kernels' device time.  It counts every query of the
window: in the cells that list it, every query takes the gather route,
whose sums are ``segment_sum``'s."""

from pilotbench import roofline
from pilotbench.metrics import family, kernel_seconds, roofline_pct, single


def read(ctx):
    if ctx.trace is None:
        return None
    br = int(ctx.config["block_rows"])
    need = 0.0
    for r in single(ctx):
        fam = family(r)
        values = sum(ch != "count" for ch in fam.CHANNELS)
        rows_total = int(ctx.config[f"{fam.TABLE}_rows"])
        passing = ctx.reference.pass_rows(r.query)
        if r.answer.exact:
            rows = passing
        else:
            blocks = r.report["n_pilot_blocks"] + sum(
                s.of(fam.TABLE).n_sampled for s in r.answer.samples[:1])
            rows = blocks * br * passing / rows_total
        need += roofline.segment_sum_bytes(int(rows), values, fam.MAX_GROUPS,
                                           len(fam.CHANNELS))
    return roofline_pct(ctx, need, kernel_seconds(ctx, lambda n: n.startswith("segment_")))
