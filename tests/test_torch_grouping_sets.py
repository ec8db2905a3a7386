"""GROUPING SETS / ROLLUP / CUBE in the port: the cases of
``tests/test_grouping_sets.py`` retargeted to ``presto1_tpu_torch`` on the
CPU at SF 0.001.  Every statement runs through the JAX package's engine as
well and the two answers are held equal as multisets of rows (the rows of
a statement without ORDER BY come in no fixed order), then against pandas
as the reference file holds them.
"""

import pytest
import torch

from presto1_tpu.exec.catalog import TpchCatalog as JTpchCatalog
from presto1_tpu.exec.engine import Engine as JEngine
from presto1_tpu_torch.exec.catalog import TpchCatalog
from presto1_tpu_torch.exec.engine import Engine

from torch_parity import same_answer

torch.set_num_threads(1)


@pytest.fixture(scope="module")
def engines():
    return (Engine(TpchCatalog(sf=0.001, device="cpu"), device="cpu"),
            JEngine(JTpchCatalog(sf=0.001)))


def _df(engines, table, cols):
    return engines[0].catalog.table(table).batch(cols).to_pandas()


def test_rollup_two_levels(engines):
    out = same_answer(*engines,
                      "select l_returnflag f, l_linestatus s, count(*) c, "
                      "sum(l_quantity) q from lineitem "
                      "group by rollup(l_returnflag, l_linestatus)",
                      ordered=False)
    df = _df(engines, "lineitem",
             ["l_returnflag", "l_linestatus", "l_quantity"])
    fine = df.groupby(["l_returnflag", "l_linestatus"]).agg(
        c=("l_quantity", "size"), q=("l_quantity", "sum"))
    lvl1 = df.groupby("l_returnflag").agg(
        c=("l_quantity", "size"), q=("l_quantity", "sum"))
    assert len(out) == len(fine) + len(lvl1) + 1
    for (f, s), r in fine.iterrows():
        row = out[(out.f == f) & (out.s == s)]
        assert int(row.c.iloc[0]) == r.c and abs(row.q.iloc[0] - r.q) < 1e-6
    for f, r in lvl1.iterrows():
        row = out[(out.f == f) & (out.s.isna())]
        assert int(row.c.iloc[0]) == r.c
    total = out[out.f.isna() & out.s.isna()]
    assert int(total.c.iloc[0]) == len(df)
    assert abs(total.q.iloc[0] - df.l_quantity.sum()) < 1e-6


def test_cube(engines):
    out = same_answer(*engines,
                      "select o_orderstatus st, o_orderpriority pr, count(*) c "
                      "from orders group by cube(o_orderstatus, "
                      "o_orderpriority)", ordered=False)
    df = _df(engines, "orders", ["o_orderstatus", "o_orderpriority"])
    fine = df.groupby(["o_orderstatus", "o_orderpriority"]).size()
    by_st = df.groupby("o_orderstatus").size()
    by_pr = df.groupby("o_orderpriority").size()
    assert len(out) == len(fine) + len(by_st) + len(by_pr) + 1
    for st, n in by_st.items():
        assert int(out[(out.st == st) & (out.pr.isna())].c.iloc[0]) == n
    for pr, n in by_pr.items():
        assert int(out[(out.pr == pr) & (out.st.isna())].c.iloc[0]) == n
    assert int(out[out.st.isna() & out.pr.isna()].c.iloc[0]) == len(df)


def test_grouping_sets_explicit_and_empty(engines):
    out = same_answer(*engines,
                      "select c_mktsegment m, c_nationkey n, count(*) c from "
                      "customer group by grouping sets ((c_mktsegment), "
                      "(c_nationkey), ())", ordered=False)
    df = _df(engines, "customer", ["c_mktsegment", "c_nationkey"])
    by_m = df.groupby("c_mktsegment").size()
    by_n = df.groupby("c_nationkey").size()
    assert len(out) == len(by_m) + len(by_n) + 1
    for m, cnt in by_m.items():
        assert int(out[(out.m == m)].c.iloc[0]) == cnt
    for n, cnt in by_n.items():
        assert int(out[(out.n == n) & (out.m.isna())].c.iloc[0]) == cnt
    assert int(out[out.m.isna() & out.n.isna()].c.iloc[0]) == len(df)


def test_plain_group_with_rollup_factor(engines):
    # GROUP BY a, ROLLUP(b) = sets {a,b},{a}
    out = same_answer(*engines,
                      "select o_orderstatus st, o_orderpriority pr, count(*) c "
                      "from orders group by o_orderstatus, "
                      "rollup(o_orderpriority)", ordered=False)
    df = _df(engines, "orders", ["o_orderstatus", "o_orderpriority"])
    fine = df.groupby(["o_orderstatus", "o_orderpriority"]).size()
    by_st = df.groupby("o_orderstatus").size()
    assert len(out) == len(fine) + len(by_st)
    for st, n in by_st.items():
        assert int(out[(out.st == st) & (out.pr.isna())].c.iloc[0]) == n


def test_rollup_having_and_order(engines):
    # ORDER BY c alone leaves ties in any order: the rows are compared as a
    # multiset, their counts in order
    out = same_answer(*engines,
                      "select l_returnflag f, l_linestatus s, count(*) c "
                      "from lineitem group by rollup(l_returnflag, "
                      "l_linestatus) having count(*) > 100 order by c desc",
                      ordered=False)
    assert (out.c > 100).all()
    assert list(out.c) == sorted(out.c, reverse=True)
