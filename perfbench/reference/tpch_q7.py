"""TPC-H Q7, the volume shipping query (TPC-H v3.0.1 §2.4.7).

Substitution: NATION1 and NATION2 two different nations of the 25
(§2.4.7.3)."""

from __future__ import annotations

import numpy as np

from .common import dec, dec_out, day, lookup, one

SQL = """
select
    supp_nation,
    cust_nation,
    l_year,
    sum(volume) as revenue
from (
    select
        n1.n_name as supp_nation,
        n2.n_name as cust_nation,
        extract(year from l_shipdate) as l_year,
        l_extendedprice * (1 - l_discount) as volume
    from supplier, lineitem, orders, customer, nation n1, nation n2
    where
        s_suppkey = l_suppkey
        and o_orderkey = l_orderkey
        and c_custkey = o_custkey
        and s_nationkey = n1.n_nationkey
        and c_nationkey = n2.n_nationkey
        and (
            (n1.n_name = '{nation1}' and n2.n_name = '{nation2}')
            or (n1.n_name = '{nation2}' and n2.n_name = '{nation1}')
        )
        and l_shipdate between date '1995-01-01' and date '1996-12-31'
) as shipping
group by supp_nation, cust_nation, l_year
order by supp_nation, cust_nation, l_year
"""

NATIONS = ["ALGERIA", "ARGENTINA", "BRAZIL", "CANADA", "EGYPT", "ETHIOPIA",
           "FRANCE", "GERMANY", "INDIA", "INDONESIA", "IRAN", "IRAQ",
           "JAPAN", "JORDAN", "KENYA", "MOROCCO", "MOZAMBIQUE", "PERU",
           "CHINA", "ROMANIA", "SAUDI ARABIA", "VIETNAM", "RUSSIA",
           "UNITED KINGDOM", "UNITED STATES"]
COLUMNS = {"supplier": ["s_suppkey", "s_nationkey"],
           "lineitem": ["l_orderkey", "l_suppkey", "l_extendedprice",
                        "l_discount", "l_shipdate"],
           "orders": ["o_orderkey", "o_custkey"],
           "customer": ["c_custkey", "c_nationkey"],
           "nation": ["n_nationkey", "n_name"]}
OUTPUT = ["exact"] * 4
ORDER_KEY = [0, 1, 2]
LIMIT = None


def draw(rng) -> dict:
    a, b = rng.choice(len(NATIONS), size=2, replace=False)
    return {"nation1": NATIONS[int(a)], "nation2": NATIONS[int(b)]}


def prepare(tables) -> dict:
    """The lines shipped in 1995-1996 with both nations' names, the year
    and the exact volume: every instance filters these."""
    s, li, o = tables["supplier"], tables["lineitem"], tables["orders"]
    c, n = tables["customer"], tables["nation"]
    ship = li["l_shipdate"].data
    m = (ship >= day("1995-01-01")) & (ship <= day("1996-12-31"))
    names = n["n_name"].decoded()
    sn, h1 = lookup(s["s_suppkey"].data, s["s_nationkey"].data,
                    li["l_suppkey"].data[m])
    ck, h2 = lookup(o["o_orderkey"].data, o["o_custkey"].data,
                    li["l_orderkey"].data[m])
    cn, h3 = lookup(c["c_custkey"].data, c["c_nationkey"].data, ck)
    sname, h4 = lookup(n["n_nationkey"].data, names, sn)
    cname, h5 = lookup(n["n_nationkey"].data, names, cn)
    keep = h1 & h2 & h3 & h4 & h5
    year = ship[m].astype("datetime64[D]").astype("datetime64[Y]") \
        .astype(np.int64) + 1970
    return {"sname": sname[keep], "cname": cname[keep], "year": year[keep],
            "price": li["l_extendedprice"].data[m][keep],
            "disc": li["l_discount"].data[m][keep]}


def answer(ctx, params: dict, lower: bool = False) -> list:
    a, b = params["nation1"], params["nation2"]
    sname, cname = ctx["sname"], ctx["cname"]
    keep = ((sname == a) & (cname == b)) | ((sname == b) & (cname == a))
    volume = dec(ctx["price"][keep], 2, lower) \
        * (one(2, lower) - dec(ctx["disc"][keep], 2, lower))
    sname, cname, year = sname[keep], cname[keep], ctx["year"][keep]
    rows = []
    for s_ in sorted(set(sname.tolist())):
        for c_ in sorted(set(cname.tolist())):
            for y in sorted(set(year.tolist())):
                g = (sname == s_) & (cname == c_) & (year == y)
                if g.any():
                    rows.append((s_, c_, int(y),
                                 dec_out(volume[g].sum(), 4, lower)))
    return rows
