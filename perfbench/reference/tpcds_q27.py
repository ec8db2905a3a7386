"""TPC-DS Q27, store sales averages by item and state with ROLLUP
subtotals (TPC-DS v3.2.0, query27.tpl).

Substitutions as dsqgen makes them: YEAR uniform in 1998-2002; GEN, MS
and ES one value each of the gender, marital-status and education
domains; STATE_A to STATE_F six distinct states of the stores' states.

The reference computes the ROLLUP's three grouping sets directly, (item,
state), (item) and (), with ``grouping(s_state)`` 0 in the first and 1 in
the others, and orders NULLs last."""

from __future__ import annotations

import torch

from ..data.tpcds_dsgen import EDUCATION, GENDERS, MARITAL, STORE_STATES
from .common import avg_out
from .tensors import code, col, decode, group_sums, lookup, valid

SQL = """
select  i_item_id,
        s_state, grouping(s_state) g_state,
        avg(ss_quantity) agg1,
        avg(ss_list_price) agg2,
        avg(ss_coupon_amt) agg3,
        avg(ss_sales_price) agg4
 from store_sales, customer_demographics, date_dim, store, item
 where ss_sold_date_sk = d_date_sk and
       ss_item_sk = i_item_sk and
       ss_store_sk = s_store_sk and
       ss_cdemo_sk = cd_demo_sk and
       cd_gender = '{gen}' and
       cd_marital_status = '{ms}' and
       cd_education_status = '{es}' and
       d_year = {year} and
       s_state in ('{state_a}','{state_b}', '{state_c}', '{state_d}','{state_e}', '{state_f}')
 group by rollup (i_item_id, s_state)
 order by i_item_id
         ,s_state
 limit 100
"""

COLUMNS = {"store_sales": ["ss_sold_date_sk", "ss_item_sk", "ss_store_sk",
                           "ss_cdemo_sk", "ss_quantity", "ss_list_price",
                           "ss_coupon_amt", "ss_sales_price"],
           "customer_demographics": ["cd_demo_sk", "cd_gender",
                                     "cd_marital_status",
                                     "cd_education_status"],
           "date_dim": ["d_date_sk", "d_year"],
           "store": ["s_store_sk", "s_state"],
           "item": ["i_item_sk", "i_item_id"]}
OUTPUT = ["exact"] * 3 + ["double"] * 4
ORDER_KEY = [0, 1]
LIMIT = 100
STATES = ("state_a", "state_b", "state_c", "state_d", "state_e", "state_f")
# the averaged columns and their decimal scales
MEASURES = (("ss_quantity", 0), ("ss_list_price", 2), ("ss_coupon_amt", 2),
            ("ss_sales_price", 2))


def draw(rng) -> dict:
    states = rng.choice(len(STORE_STATES), size=len(STATES), replace=False)
    return {"year": int(rng.integers(1998, 2003)),
            "gen": GENDERS[int(rng.integers(len(GENDERS)))],
            "ms": MARITAL[int(rng.integers(len(MARITAL)))],
            "es": EDUCATION[int(rng.integers(len(EDUCATION)))],
            **{k: STORE_STATES[int(s)] for k, s in zip(STATES, states)}}


def prepare(tables) -> dict:
    """The star join of every sale whose four keys all find their row:
    each sale's year, state, demographics and item code."""
    ss, cd = tables["store_sales"], tables["customer_demographics"]
    d, s, i = tables["date_dim"], tables["store"], tables["item"]
    rows, keep = {}, None
    for name, fk, pk in (("date", "ss_sold_date_sk", d["d_date_sk"]),
                         ("store", "ss_store_sk", s["s_store_sk"]),
                         ("cd", "ss_cdemo_sk", cd["cd_demo_sk"]),
                         ("item", "ss_item_sk", i["i_item_sk"])):
        rows[name], hit = lookup(col(pk), col(ss[fk]), valid(ss[fk]))
        keep = hit if keep is None else keep & hit
    at = {k: r[keep] for k, r in rows.items()}
    return {
        "year": col(d["d_year"])[at["date"]],
        "state": col(s["s_state"])[at["store"]],
        "gender": col(cd["cd_gender"])[at["cd"]],
        "ms": col(cd["cd_marital_status"])[at["cd"]],
        "es": col(cd["cd_education_status"])[at["cd"]],
        "item": col(i["i_item_id"])[at["item"]],
        "measures": [col(ss[c])[keep] for c, _ in MEASURES],
        "columns": {"state": s["s_state"], "item": i["i_item_id"],
                    "gender": cd["cd_gender"], "ms": cd["cd_marital_status"],
                    "es": cd["cd_education_status"]},
    }


def answer(ctx, params: dict, lower: bool = False) -> list:
    c = ctx["columns"]
    states = torch.tensor([code(c["state"], params[k]) for k in STATES])
    m = (ctx["year"] == params["year"]) \
        & (ctx["gender"] == code(c["gender"], params["gen"])) \
        & (ctx["ms"] == code(c["ms"], params["ms"])) \
        & (ctx["es"] == code(c["es"], params["es"])) \
        & torch.isin(ctx["state"], states)
    item, state = ctx["item"][m], ctx["state"][m]
    measures = [v[m] for v in ctx["measures"]]
    if lower:
        measures = [(v.to(torch.float64) / 10 ** scale).to(torch.float32)
                    for v, (_, scale) in zip(measures, MEASURES)]
    n_states = len(c["state"].dictionary)
    rows = []
    # the ROLLUP's grouping sets and grouping(s_state) in each
    for keys, g in (((item, state), 0), ((item,), 1), ((), 1)):
        if not keys:  # the grand total: one row, even over no sale
            sums = [v.sum().item() for v in measures]
            rows.append((None, None, g, *(
                avg_out(sums[k], len(item), scale, lower)
                for k, (_, scale) in enumerate(MEASURES))))
            continue
        key = item if len(keys) == 1 else item * n_states + state
        uniq, sums, counts = group_sums(key, measures)
        sums, counts = [v.tolist() for v in sums], counts.tolist()
        items = decode(c["item"], uniq // n_states if len(keys) == 2
                       else uniq)
        st = decode(c["state"], uniq % n_states) if len(keys) == 2 \
            else [None] * len(uniq)
        for j in range(len(uniq)):
            rows.append((items[j], st[j], g, *(
                avg_out(sums[k][j], counts[j], scale, lower)
                for k, (_, scale) in enumerate(MEASURES))))
    rows.sort(key=lambda r: (r[0] is None, r[0] or "", r[1] is None,
                             r[1] or ""))
    return rows
