"""TPC-H Q14, the promotion effect query (spec Clause 2.4.14), as the spec
writes it: ``lineitem`` joined with ``part`` on ``l_partkey = p_partkey``,
the share of one month's revenue from promoted parts.  ``p_promo`` is a
column of ``part``: its ``p_type LIKE 'PROMO%'`` as 0 or 1.  The spec's
factor of 100 is left out.

Substitution parameter: the first of a MONTH in 1993-1997.
"""

from pilotbench.reference import q14

TABLE = "lineitem"
JOINS = (("part", "l_partkey", "p_partkey"),)
SQL = ("SELECT SUM(l_extendedprice * (1 - l_discount) * p_promo) / "
       "SUM(l_extendedprice * (1 - l_discount)) AS promo_share FROM lineitem "
       "JOIN part ON l_partkey = p_partkey "
       "WHERE l_shipdate >= {date_lo} AND l_shipdate < {date_hi}")
COLUMNS = q14.COLUMNS
GROUP_BY = None
MAX_GROUPS = 1
CHANNELS = q14.CHANNELS
COMPOSITES = q14.COMPOSITES
placeholders, mask, values = q14.placeholders, q14.mask, q14.values
