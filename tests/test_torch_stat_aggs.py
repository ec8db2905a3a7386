"""Statistical aggregates, NULL-producing CASE, set operations and ordinals
in the port: the cases of ``tests/test_stat_aggs.py`` retargeted to
``presto1_tpu_torch`` on the CPU at SF 0.001.  Every statement runs through
the JAX package's engine as well and the two answers are held equal
(integers exact, doubles to 1e-6 relative), then against pandas / numpy as
the reference file holds them.  Its approx_distinct cases are held by
``tests/test_torch_hll.py`` and are not repeated here.
"""

import numpy as np
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


@pytest.fixture(scope="module")
def li(engines):
    return engines[0].catalog.table("lineitem").batch(
        ["l_orderkey", "l_quantity", "l_extendedprice", "l_discount",
         "l_returnflag"]).to_pandas()


def test_variance_stddev_global(engines, li):
    out = same_answer(*engines,
                      "select var_samp(l_quantity) vs, var_pop(l_quantity) "
                      "vp, stddev(l_quantity) sd, stddev_pop(l_quantity) sp, "
                      "variance(l_quantity) v from lineitem")
    x = li.l_quantity.astype(float)
    assert np.isclose(out.vs[0], x.var(ddof=1), rtol=1e-9)
    assert np.isclose(out.vp[0], x.var(ddof=0), rtol=1e-9)
    assert np.isclose(out.sd[0], x.std(ddof=1), rtol=1e-9)
    assert np.isclose(out.sp[0], x.std(ddof=0), rtol=1e-9)
    assert np.isclose(out.v[0], x.var(ddof=1), rtol=1e-9)


def test_grouped_stddev(engines, li):
    out = same_answer(*engines,
                      "select l_returnflag f, stddev(l_extendedprice) sd "
                      "from lineitem group by l_returnflag order by f")
    exp = li.groupby("l_returnflag").l_extendedprice.std(ddof=1)
    for f, sd in zip(out.f, out.sd):
        assert np.isclose(sd, exp[f], rtol=1e-8), (f, sd, exp[f])


def test_covar_corr(engines, li):
    out = same_answer(*engines,
                      "select covar_samp(l_quantity, l_extendedprice) cs, "
                      "covar_pop(l_quantity, l_extendedprice) cp, "
                      "corr(l_quantity, l_extendedprice) r from lineitem")
    x = li.l_quantity.astype(float)
    y = li.l_extendedprice.astype(float)
    assert np.isclose(out.cs[0], np.cov(x, y, ddof=1)[0, 1], rtol=1e-8)
    assert np.isclose(out.cp[0], np.cov(x, y, ddof=0)[0, 1], rtol=1e-8)
    assert np.isclose(out.r[0], np.corrcoef(x, y)[0, 1], rtol=1e-8)


def test_regr(engines, li):
    out = same_answer(*engines,
                      "select regr_slope(l_extendedprice, l_quantity) s, "
                      "regr_intercept(l_extendedprice, l_quantity) i "
                      "from lineitem")
    x = li.l_quantity.astype(float)
    y = li.l_extendedprice.astype(float)
    slope, intercept = np.polyfit(x, y, 1)
    assert np.isclose(out.s[0], slope, rtol=1e-6)
    assert np.isclose(out.i[0], intercept, rtol=1e-6)


def test_bool_and_or(engines):
    out = same_answer(*engines,
                      "select bool_and(l_quantity > 0) ba, "
                      "bool_or(l_quantity > 49) bo, every(l_quantity > 25) "
                      "ev from lineitem")
    assert bool(out.ba[0]) is True
    assert bool(out.bo[0]) is True
    assert bool(out.ev[0]) is False


def test_arbitrary_and_geometric_mean(engines, li):
    # arbitrary() may pick any row: held to the column's values, and the
    # geometric mean to the reference's
    engine, reference = engines
    sql = ("select arbitrary(l_returnflag) a, geometric_mean(l_quantity) g "
           "from lineitem")
    out, want = engine.sql(sql).to_pandas(), reference.sql(sql).to_pandas()
    assert out.a[0] in set(li.l_returnflag)
    x = li.l_quantity.astype(float)
    assert np.isclose(out.g[0], np.exp(np.log(x).mean()), rtol=1e-9)
    assert np.isclose(out.g[0], want.g[0], rtol=1e-6)


def test_variance_single_row_is_null(engines):
    out = same_answer(*engines,
                      "select var_samp(n_nationkey) v, stddev(n_nationkey) s "
                      "from nation where n_nationkey = 3")
    assert out.v[0] is None and out.s[0] is None


def test_case_without_else_is_null(engines):
    out = same_answer(*engines,
                      "select sum(case when l_quantity > 1e9 then 1 end) s, "
                      "count(case when l_returnflag = 'A' then 1 end) c, "
                      "count(*) n, sum(case when l_returnflag = 'A' then 1 "
                      "else 0 end) sa from lineitem")
    assert out.s[0] is None  # sum over all-NULL input
    assert int(out.c[0]) == int(out.sa[0])  # count skips NULL branches
    assert int(out.c[0]) < int(out.n[0])


def test_scalar_ln_exp(engines):
    out = same_answer(*engines,
                      "select ln(exp(2.5)) a, log2(8) b, log10(1000) c "
                      "from nation limit 1")
    assert np.isclose(out.a[0], 2.5)
    assert np.isclose(out.b[0], 3.0)
    assert np.isclose(out.c[0], 3.0)


def test_mixed_distinct_aggregates(engines, li):
    out = same_answer(*engines,
                      "select l_returnflag f, count(distinct l_orderkey) d, "
                      "count(*) c, sum(l_quantity) s, avg(l_quantity) a, "
                      "max(l_discount) m from lineitem group by l_returnflag "
                      "order by f")
    exp = li.groupby("l_returnflag").agg(
        d=("l_orderkey", "nunique"), c=("l_orderkey", "size"),
        s=("l_quantity", "sum"), a=("l_quantity", "mean"),
        m=("l_discount", "max"))
    for r in out.itertuples():
        e = exp.loc[r.f]
        assert int(r.d) == e.d and int(r.c) == e.c
        assert np.isclose(r.s, e.s) and np.isclose(r.a, e.a)
        assert np.isclose(r.m, e.m)


def test_global_mixed_distinct(engines):
    out = same_answer(*engines,
                      "select count(distinct l_suppkey) d, "
                      "sum(l_extendedprice) s, count(*) c from lineitem")
    df = engines[0].catalog.table("lineitem").batch(
        ["l_suppkey", "l_extendedprice"]).to_pandas()
    assert int(out.d[0]) == df.l_suppkey.nunique()
    assert np.isclose(out.s[0], df.l_extendedprice.sum())
    assert int(out.c[0]) == len(df)


def test_percentiles_global_and_grouped(engines, li):
    out = same_answer(*engines,
                      "select approx_percentile(l_extendedprice, 0.5) p50, "
                      "approx_percentile(l_extendedprice, 0.9) p90, "
                      "median(l_quantity) m from lineitem")
    x = np.sort(li.l_extendedprice.values)
    q = np.sort(li.l_quantity.values)
    assert np.isclose(out.p50[0], x[round(0.5 * (len(x) - 1))])
    assert np.isclose(out.p90[0], x[round(0.9 * (len(x) - 1))])
    assert np.isclose(out.m[0], q[round(0.5 * (len(q) - 1))])
    g = same_answer(*engines,
                    "select l_returnflag f, approx_percentile(l_quantity, "
                    "0.25) q1 from lineitem group by l_returnflag order by f")
    for f, got in zip(g.f, g.q1):
        xs = np.sort(li[li.l_returnflag == f].l_quantity.values)
        assert np.isclose(got, xs[round(0.25 * (len(xs) - 1))])


def test_intersect_except(engines):
    engine = engines[0]
    got = same_answer(*engines,
                      "select c_nationkey from customer intersect "
                      "select s_nationkey from supplier order by c_nationkey")
    cust = set(engine.catalog.table("customer").batch(
        ["c_nationkey"]).to_pandas().c_nationkey)
    supp = set(engine.catalog.table("supplier").batch(
        ["s_nationkey"]).to_pandas().s_nationkey)
    assert list(got.iloc[:, 0]) == sorted(cust & supp)
    got = same_answer(*engines,
                      "select n_nationkey from nation except "
                      "select s_nationkey from supplier order by n_nationkey")
    assert list(got.iloc[:, 0]) == sorted(set(range(25)) - supp)
    # precedence: INTERSECT binds tighter than UNION
    got = same_answer(*engines,
                      "select 1 union select 2 intersect select 2",
                      ordered=False)
    assert sorted(got.iloc[:, 0]) == [1, 2]


def test_order_group_by_ordinals(engines):
    out = same_answer(*engines,
                      "select n_name, n_regionkey from nation "
                      "order by 2 desc, 1 limit 3")
    assert (out.n_regionkey == 4).all()
    assert list(out.n_name) == sorted(out.n_name)
    out = same_answer(*engines,
                      "select n_regionkey, count(*) c from nation group by 1 "
                      "order by 1")
    assert list(out.n_regionkey) == [0, 1, 2, 3, 4]
    assert (out.c == 5).all()
    out = same_answer(*engines, "select 2 union select 1 order by 1")
    assert list(out.iloc[:, 0]) == [1, 2]
