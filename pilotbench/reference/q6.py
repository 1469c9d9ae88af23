"""TPC-H Q6, the forecasting revenue change query (spec Clause 2.4.6), as
the spec writes it: ``l_shipdate >= date AND l_shipdate < date + 1 year``.

Substitution parameters: YEAR in 1993-1997, DISCOUNT in 0.02-0.09,
QUANTITY 24 or 25.  The predicates compare the stored columns with the
literals, as the SQL does; the revenue is computed through ``cast``.
"""

from pilotbench.reference import tpch_days

TABLE = "lineitem"
SQL = ("SELECT SUM(l_extendedprice * l_discount) AS revenue FROM lineitem "
       "WHERE l_shipdate >= {date_lo} AND l_shipdate < {date_hi} "
       "AND l_discount BETWEEN {disc_lo:.2f} AND {disc_hi:.2f} "
       "AND l_quantity < {quantity}")
COLUMNS = ("l_shipdate", "l_discount", "l_quantity", "l_extendedprice")
GROUP_BY = None
MAX_GROUPS = 1
CHANNELS = ("revenue", "count")
COMPOSITES = (("revenue", "sum", (0,)),)


def placeholders(p):
    d = round(float(p["discount"]), 2)
    return {"date_lo": tpch_days(int(p["year"])),
            "date_hi": tpch_days(int(p["year"]) + 1),
            "disc_lo": round(d - 0.01, 2), "disc_hi": round(d + 0.01, 2),
            "quantity": int(p["quantity"])}


def mask(cols, ph):
    sd, disc, qty = cols["l_shipdate"], cols["l_discount"], cols["l_quantity"]
    return ((sd >= ph["date_lo"]) & (sd < ph["date_hi"])
            & (disc >= ph["disc_lo"]) & (disc <= ph["disc_hi"])
            & (qty < ph["quantity"]))


def values(cols, cast):
    return {"revenue": cast(cols["l_extendedprice"]) * cast(cols["l_discount"])}
