"""TPC-H Q3, the shipping priority query (TPC-H v3.0.1 §2.4.3).

Substitution: SEGMENT one of the five market segments, DATE a day in
[1995-03-01, 1995-03-31] (§2.4.3.3)."""

from __future__ import annotations

import numpy as np

from .common import dec, dec_out, day, iso, limited, lookup, one

SQL = """
select
    l_orderkey,
    sum(l_extendedprice * (1 - l_discount)) as revenue,
    o_orderdate,
    o_shippriority
from customer, orders, lineitem
where
    c_mktsegment = '{segment}'
    and c_custkey = o_custkey
    and l_orderkey = o_orderkey
    and o_orderdate < date '{date}'
    and l_shipdate > date '{date}'
group by l_orderkey, o_orderdate, o_shippriority
order by revenue desc, o_orderdate
limit 10
"""

SEGMENTS = ["AUTOMOBILE", "BUILDING", "FURNITURE", "MACHINERY", "HOUSEHOLD"]
COLUMNS = {"customer": ["c_custkey", "c_mktsegment"],
           "orders": ["o_orderkey", "o_custkey", "o_orderdate",
                      "o_shippriority"],
           "lineitem": ["l_orderkey", "l_extendedprice", "l_discount",
                        "l_shipdate"]}
OUTPUT = ["exact"] * 4
ORDER_KEY = [1, 2]
LIMIT = 10


def draw(rng) -> dict:
    return {"segment": SEGMENTS[int(rng.integers(0, 5))],
            "date": iso(day("1995-03-01") + int(rng.integers(0, 31)))}


def prepare(tables) -> dict:
    c, o, li = tables["customer"], tables["orders"], tables["lineitem"]
    segment, _ = lookup(c["c_custkey"].data, c["c_mktsegment"].decoded(),
                        o["o_custkey"].data)
    # each line's order row (every line has one)
    row, hit = lookup(o["o_orderkey"].data,
                      np.arange(len(o["o_orderkey"].data)),
                      li["l_orderkey"].data)
    if not hit.all():
        raise ValueError("a lineitem row has no order")
    return {"o": o, "li": li, "segment": segment, "row": row}


def answer(ctx, params: dict, lower: bool = False) -> list:
    o, li, d = ctx["o"], ctx["li"], day(params["date"])
    order_ok = (ctx["segment"] == params["segment"]) \
        & (o["o_orderdate"].data < d)
    m = order_ok[ctx["row"]] & (li["l_shipdate"].data > d)
    keys = li["l_orderkey"].data[m]
    rev = dec(li["l_extendedprice"].data[m], 2, lower) \
        * (one(2, lower) - dec(li["l_discount"].data[m], 2, lower))
    order = np.argsort(keys, kind="stable")
    keys, rev = keys[order], rev[order]
    uniq, starts = np.unique(keys, return_index=True)
    sums = np.add.reduceat(rev, starts) if len(uniq) else rev[:0]
    rows = ctx["row"][m][order][starts]
    odate = o["o_orderdate"].data[rows]
    prio = o["o_shippriority"].data[rows]
    top = limited(np.lexsort((odate, -sums)), [sums, odate], LIMIT)
    return [(int(uniq[i]), dec_out(sums[i], 4, lower), int(odate[i]),
             int(prio[i])) for i in top]
