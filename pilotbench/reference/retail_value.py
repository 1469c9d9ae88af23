"""One year's lines over ``lineitem`` joined with ``part`` on ``l_partkey =
p_partkey``, valued at the part's list price: SUM(l_quantity *
p_retailprice), which dbgen's pricing makes the year's gross
``l_extendedprice``.  A SUM, so it carries the sample's scale; it reads a
column of ``part`` in every passing row, so a part block left out of a
sample moves it.

Substitution parameter: YEAR in 1993-1997.
"""

from pilotbench.reference import tpch_days

TABLE = "lineitem"
JOINS = (("part", "l_partkey", "p_partkey"),)
SQL = ("SELECT SUM(l_quantity * p_retailprice) AS retail_value "
       "FROM lineitem JOIN part ON l_partkey = p_partkey "
       "WHERE l_shipdate >= {date_lo} AND l_shipdate < {date_hi}")
COLUMNS = ("l_shipdate", "l_quantity", "p_retailprice")
GROUP_BY = None
MAX_GROUPS = 1
CHANNELS = ("retail_value", "count")
COMPOSITES = (("retail_value", "sum", (0,)),)


def placeholders(p):
    return {"date_lo": tpch_days(int(p["year"])), "date_hi": tpch_days(int(p["year"]) + 1)}


def mask(cols, ph):
    sd = cols["l_shipdate"]
    return (sd >= ph["date_lo"]) & (sd < ph["date_hi"])


def values(cols, cast):
    return {"retail_value": cast(cols["l_quantity"]) * cast(cols["p_retailprice"])}
