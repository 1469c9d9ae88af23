"""TPC-H Q1, the pricing summary report (spec Clause 2.4.1), whole: its
eight aggregates by (l_returnflag, l_linestatus), grouped through
``l_rf_ls``, the one code of the pair (AF, NF, NO, RF, Q1's own order).

Substitution parameter: DELTA in 60-120, so ``l_shipdate <= 1998-12-01 -
DELTA days``.
"""

from pilotbench.reference import tpch_days

TABLE = "lineitem"
SQL = ("SELECT SUM(l_quantity) AS sum_qty, SUM(l_extendedprice) AS sum_base_price, "
       "SUM(l_extendedprice * (1 - l_discount)) AS sum_disc_price, "
       "SUM(l_extendedprice * (1 - l_discount) * (1 + l_tax)) AS sum_charge, "
       "AVG(l_quantity) AS avg_qty, AVG(l_extendedprice) AS avg_price, "
       "AVG(l_discount) AS avg_disc, COUNT(*) AS count_order FROM lineitem "
       "WHERE l_shipdate <= {date_hi} GROUP BY l_rf_ls")
COLUMNS = ("l_shipdate", "l_quantity", "l_extendedprice", "l_discount", "l_tax")
GROUP_BY = "l_rf_ls"
MAX_GROUPS = 4
CHANNELS = ("l_quantity", "l_extendedprice", "disc_price", "charge", "l_discount", "count")
COMPOSITES = (("sum_qty", "sum", (0,)), ("sum_base_price", "sum", (1,)),
              ("sum_disc_price", "sum", (2,)), ("sum_charge", "sum", (3,)),
              ("avg_qty", "avg", (0, 5)), ("avg_price", "avg", (1, 5)),
              ("avg_disc", "avg", (4, 5)), ("count_order", "count", (5,)))


def placeholders(p):
    return {"date_hi": tpch_days(1998, 12) - int(p["delta"])}


def mask(cols, ph):
    return cols["l_shipdate"] <= ph["date_hi"]


def values(cols, cast):
    price, disc = cast(cols["l_extendedprice"]), cast(cols["l_discount"])
    disc_price = price * (1 - disc)
    return {"l_quantity": cast(cols["l_quantity"]), "l_extendedprice": price,
            "disc_price": disc_price, "charge": disc_price * (1 + cast(cols["l_tax"])),
            "l_discount": disc}
