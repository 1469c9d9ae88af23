"""TPC-H Q14, the promotion effect query (spec Clause 2.4.14): the share of
one month's revenue from promoted parts.  ``p_promo`` is part's ``p_type
LIKE 'PROMO%'`` read at each line's part key, in place of the join with
``part``; the spec's factor of 100 is left out.

Substitution parameter: the first of a MONTH in 1993-1997.
"""

from pilotbench.reference import tpch_days

TABLE = "lineitem"
SQL = ("SELECT SUM(l_extendedprice * (1 - l_discount) * p_promo) / "
       "SUM(l_extendedprice * (1 - l_discount)) AS promo_share FROM lineitem "
       "WHERE l_shipdate >= {date_lo} AND l_shipdate < {date_hi}")
COLUMNS = ("l_shipdate", "l_extendedprice", "l_discount", "p_promo")
GROUP_BY = None
MAX_GROUPS = 1
CHANNELS = ("promo", "revenue", "count")
COMPOSITES = (("promo_share", "ratio", (0, 1)),)


def placeholders(p):
    y, m = int(p["year"]), int(p["month"])
    nxt = (y + 1, 1) if m == 12 else (y, m + 1)
    return {"date_lo": tpch_days(y, m), "date_hi": tpch_days(*nxt)}


def mask(cols, ph):
    sd = cols["l_shipdate"]
    return (sd >= ph["date_lo"]) & (sd < ph["date_hi"])


def values(cols, cast):
    revenue = cast(cols["l_extendedprice"]) * (1 - cast(cols["l_discount"]))
    return {"promo": revenue * cast(cols["p_promo"]), "revenue": revenue}
