"""TPC-DS Q93, customers' sales net of their returns for one return
reason (TPC-DS v3.2.0, query93.tpl).

Substitution as dsqgen makes it: REASON one of the reason table's 35
descriptions.

The reference left-joins every sold line to its return by (item, ticket);
the comma join to ``reason`` and its filter then keep the lines returned
for that reason (a line without a return has a NULL ``sr_reason_sk`` and
matches no reason).  ``act_sales`` is the spec's CASE over the NULL-
extended return quantity; the sums group by ``ss_customer_sk``, NULL a
group of its own and ordered last."""

from __future__ import annotations

import torch

from ..data.tpcds_dsgen import REASONS
from .common import dec_out
from .tensors import code, col, group_sums, lookup, valid

SQL = """
select  ss_customer_sk
            ,sum(act_sales) sumsales
      from (select ss_item_sk
                  ,ss_ticket_number
                  ,ss_customer_sk
                  ,case when sr_return_quantity is not null then (ss_quantity-sr_return_quantity)*ss_sales_price
                                                            else (ss_quantity*ss_sales_price) end act_sales
            from store_sales left outer join store_returns on (sr_item_sk = ss_item_sk
                                                               and sr_ticket_number = ss_ticket_number)
                ,reason
            where sr_reason_sk = r_reason_sk
              and r_reason_desc = '{reason}') t
      group by ss_customer_sk
      order by sumsales, ss_customer_sk
limit 100
"""

COLUMNS = {"store_sales": ["ss_item_sk", "ss_ticket_number",
                           "ss_customer_sk", "ss_quantity",
                           "ss_sales_price"],
           "store_returns": ["sr_item_sk", "sr_ticket_number",
                             "sr_return_quantity", "sr_reason_sk"],
           "reason": ["r_reason_sk", "r_reason_desc"]}
OUTPUT = ["exact", "exact"]
ORDER_KEY = [1, 0]
LIMIT = 100


def draw(rng) -> dict:
    return {"reason": REASONS[int(rng.integers(len(REASONS)))]}


def prepare(tables) -> dict:
    """Every sold line that the left join and the reason join keep, with
    its reason's description code, its customer and its ``act_sales``."""
    ss, sr, r = tables["store_sales"], tables["store_returns"], \
        tables["reason"]
    tickets = int(col(ss["ss_ticket_number"]).max()) + 1

    def pair(item, ticket):
        return col(item) * tickets + col(ticket)

    ret, returned = lookup(
        pair(sr["sr_item_sk"], sr["sr_ticket_number"]),
        pair(ss["ss_item_sk"], ss["ss_ticket_number"]),
        torch.ones(len(ss["ss_item_sk"].data), dtype=torch.bool))
    # the NULL-extended side of the left join
    ret_qty = col(sr["sr_return_quantity"])[ret]
    qty_known = returned & valid(sr["sr_return_quantity"])[ret]
    reason_sk = col(sr["sr_reason_sk"])[ret]
    reason_known = returned & valid(sr["sr_reason_sk"])[ret]
    why, keep = lookup(col(r["r_reason_sk"]), reason_sk, reason_known)
    qty, price = col(ss["ss_quantity"]), col(ss["ss_sales_price"])
    act = torch.where(qty_known, (qty - ret_qty) * price, qty * price)
    return {"reason": col(r["r_reason_desc"])[why][keep],
            "customer": col(ss["ss_customer_sk"])[keep],
            "customer_known": valid(ss["ss_customer_sk"])[keep],
            "act_sales": act[keep], "desc": r["r_reason_desc"]}


def answer(ctx, params: dict, lower: bool = False) -> list:
    m = ctx["reason"] == code(ctx["desc"], params["reason"])
    known = ctx["customer_known"][m]
    # customer keys are positive: -1 stands for the NULL group
    key = torch.where(known, ctx["customer"][m], torch.tensor(-1))
    act = ctx["act_sales"][m]
    if lower:
        act = act.to(torch.float64) / 100
    uniq, (sums,), _ = group_sums(key, [act])
    rows = [(None if k < 0 else k, v)
            for k, v in zip(uniq.tolist(), sums.tolist())]
    rows.sort(key=lambda row: (row[1], row[0] is None, row[0] or 0))
    return [(k, dec_out(v, 2, lower)) for k, v in rows]
