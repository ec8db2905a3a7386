"""TPC-H Q1, the pricing summary report (TPC-H v3.0.1 §2.4.1).

Substitution: DELTA uniform in [60, 120] days (§2.4.1.3)."""

from __future__ import annotations

import numpy as np

from .common import avg_out, dec, dec_out, day, one

SQL = """
select
    l_returnflag,
    l_linestatus,
    sum(l_quantity) as sum_qty,
    sum(l_extendedprice) as sum_base_price,
    sum(l_extendedprice * (1 - l_discount)) as sum_disc_price,
    sum(l_extendedprice * (1 - l_discount) * (1 + l_tax)) as sum_charge,
    avg(l_quantity) as avg_qty,
    avg(l_extendedprice) as avg_price,
    avg(l_discount) as avg_disc,
    count(*) as count_order
from lineitem
where l_shipdate <= date '1998-12-01' - interval '{delta}' day
group by l_returnflag, l_linestatus
order by l_returnflag, l_linestatus
"""

COLUMNS = {"lineitem": ["l_returnflag", "l_linestatus", "l_quantity",
                        "l_extendedprice", "l_discount", "l_tax",
                        "l_shipdate"]}
OUTPUT = ["exact"] * 6 + ["double"] * 3 + ["exact"]
ORDER_KEY = [0, 1]
LIMIT = None


def draw(rng) -> dict:
    return {"delta": int(rng.integers(60, 121))}


def prepare(tables) -> dict:
    """Each (flag, status) group's rows in ship-date order with running
    exact sums: an instance's sums are the running sums at its cut-off."""
    li = tables["lineitem"]
    rf, ls = li["l_returnflag"], li["l_linestatus"]
    ship = li["l_shipdate"].data
    price = li["l_extendedprice"].data.astype(np.int64)
    disc = li["l_discount"].data.astype(np.int64)
    disc_price = price * (100 - disc)                      # scale 4
    measures = [li["l_quantity"].data.astype(np.int64), price,
                disc_price, disc_price * (100 + li["l_tax"].data), disc]
    groups = []
    for f, f_name in enumerate(rf.dictionary):
        for s, s_name in enumerate(ls.dictionary):
            rows = np.flatnonzero((rf.data == f) & (ls.data == s))
            rows = rows[np.argsort(ship[rows], kind="stable")]
            groups.append((str(f_name), str(s_name), ship[rows],
                           [np.cumsum(m[rows]) for m in measures]))
    return {"li": li, "groups": groups}


def answer(ctx, params: dict, lower: bool = False) -> list:
    cut = day("1998-12-01") - params["delta"]
    if lower:
        return _lower(ctx["li"], cut)
    rows = []
    for f, s, ship, sums in ctx["groups"]:
        c = int(np.searchsorted(ship, cut, side="right"))
        if c == 0:
            continue
        sq, sp, sdp, sch, sd = (int(x[c - 1]) for x in sums)
        rows.append((f, s, dec_out(sq, 2, False), dec_out(sp, 2, False),
                     dec_out(sdp, 4, False), dec_out(sch, 6, False),
                     avg_out(sq, c, 2, False), avg_out(sp, c, 2, False),
                     avg_out(sd, c, 2, False), c))
    return rows


def _lower(li, cut) -> list:
    """The same answer one precision down: decimals as float64, the
    averages in float32."""
    m = li["l_shipdate"].data <= cut
    rf, ls = li["l_returnflag"], li["l_linestatus"]
    qty = dec(li["l_quantity"].data[m], 2, True)
    price = dec(li["l_extendedprice"].data[m], 2, True)
    disc = dec(li["l_discount"].data[m], 2, True)
    tax = dec(li["l_tax"].data[m], 2, True)
    disc_price = price * (one(2, True) - disc)
    charge = disc_price * (one(2, True) + tax)
    flag, status = rf.data[m], ls.data[m]
    rows = []
    for f, f_name in enumerate(rf.dictionary):
        for s, s_name in enumerate(ls.dictionary):
            g = (flag == f) & (status == s)
            c = int(g.sum())
            if c == 0:
                continue
            rows.append((str(f_name), str(s_name),
                         dec_out(qty[g].sum(), 2, True),
                         dec_out(price[g].sum(), 2, True),
                         dec_out(disc_price[g].sum(), 4, True),
                         dec_out(charge[g].sum(), 6, True),
                         *(avg_out(v[g].astype(np.float32).sum(), c, 2, True)
                           for v in (qty, price, disc)), c))
    return rows
