"""TPC-H Q6, the forecasting revenue change query (TPC-H v3.0.1 §2.4.6).

Substitution: DATE the first of January of a year in [1993, 1997],
DISCOUNT in [0.02, 0.09], QUANTITY 24 or 25 (§2.4.6.3)."""

from __future__ import annotations

from .common import dec, dec_out, day

SQL = """
select
    sum(l_extendedprice * l_discount) as revenue
from lineitem
where
    l_shipdate >= date '{year}-01-01'
    and l_shipdate < date '{year}-01-01' + interval '1' year
    and l_discount between {discount} - 0.01 and {discount} + 0.01
    and l_quantity < {quantity}
"""

COLUMNS = {"lineitem": ["l_shipdate", "l_discount", "l_quantity",
                        "l_extendedprice"]}
OUTPUT = ["exact"]
ORDER_KEY = []
LIMIT = None


def draw(rng) -> dict:
    return {"year": int(rng.integers(1993, 1998)),
            "discount": f"0.0{int(rng.integers(2, 10))}",
            "quantity": int(rng.integers(24, 26))}


def prepare(tables) -> dict:
    return tables["lineitem"]


def answer(li, params: dict, lower: bool = False) -> list:
    y, disc = params["year"], round(float(params["discount"]) * 100)
    ship, d = li["l_shipdate"].data, li["l_discount"].data
    m = (ship >= day(f"{y}-01-01")) & (ship < day(f"{y + 1}-01-01")) \
        & (d >= disc - 1) & (d <= disc + 1) \
        & (li["l_quantity"].data < params["quantity"] * 100)
    if not m.any():
        return [(None,)]
    rev = (dec(li["l_extendedprice"].data[m], 2, lower)
           * dec(d[m], 2, lower)).sum()
    return [(dec_out(rev, 4, lower),)]
