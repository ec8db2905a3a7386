"""Grouped compiled execution in the port (``exec/grouped.py``,
``Engine.compile_grouped``) against the JAX package's: the dominant table
row-sharded into K splits, one compiled partial program per shard shape
(at most two), the partials merged by ``concat_batches`` (the dynamic-copy
kernel) and finished by the final aggregation.

Every grouped answer equals the port's ``Engine.sql`` of the statement and
the JAX package's; ``info`` equals the JAX package's.  Two defects of the
JAX package are held here as the port's regressions: TPC-H Q18, where it
shards both scans of lineitem and answers 3 rows where its ``Engine.sql``
answers 1 (the port refuses the plan: ROADMAP C6), and TPC-H Q3, where
later shards' order keys fall outside the first shard's recorded key
range and collide (the port widens the ranges to the table's and guards
them: ROADMAP C7).
"""

import pytest
import torch

import presto1_tpu.exec.catalog as j_catalog
import presto1_tpu.exec.engine as j_engine
import presto1_tpu_torch.exec.catalog as t_catalog
import presto1_tpu_torch.exec.engine as t_engine
from presto1_tpu_torch.tpch.queries import QUERIES

from test_tpch import assert_frames_match

torch.set_num_threads(1)

Q1_SHAPE = ("select l_returnflag, l_linestatus, sum(l_quantity) sq, "
            "count(*) c, avg(l_extendedprice) ap from lineitem "
            "where l_shipdate <= date '1998-09-02' "
            "group by l_returnflag, l_linestatus "
            "order by l_returnflag, l_linestatus")
JOIN_SHAPE = ("select o_orderpriority, count(*) c, sum(l_extendedprice) s "
              "from lineitem, orders where l_orderkey = o_orderkey "
              "group by o_orderpriority order by o_orderpriority")
# name -> (statement, K); the first two are tests/test_spill.py's
CASES = {"q1_shape": (Q1_SHAPE, 5), "join_shape": (JOIN_SHAPE, 3),
         "tpch_q1": (QUERIES[1], 4), "tpch_q6": (QUERIES[6], 8)}


@pytest.fixture(scope="module")
def engines():
    return (j_engine.Engine(j_catalog.TpchCatalog(sf=0.005)),
            t_engine.Engine(t_catalog.TpchCatalog(sf=0.005, device="cpu"),
                            device="cpu"))


@pytest.mark.parametrize("name", sorted(CASES))
def test_grouped_matches_sql_and_the_reference(engines, name):
    je, te = engines
    sql, k = CASES[name]
    tq = te.compile_grouped(sql, n_groups=k)
    got = tq().to_pandas()
    assert_frames_match(got, te.sql(sql).to_pandas(), ordered=True)
    jq = je.compile_grouped(sql, n_groups=k)
    assert_frames_match(got, jq().to_pandas(), ordered=True)
    assert tq.info == jq.info
    assert tq.info["runs"] == k and tq.info["table"] == "lineitem"
    assert tq.info["programs"] <= 2  # shard sizes differ by <= 1 row


def test_grouped_q6_keeps_the_fused_kernel_route(engines):
    """Each shard's partial ``sum(l_extendedprice * l_discount)`` is still
    the range-filter product sum (``filter_sum``), not the generic
    aggregate."""
    _, te = engines
    tq = te.compile_grouped(QUERIES[6], n_groups=4)
    tq()
    for cq in tq._programs.values():
        assert cq.record[()]["range_sum"] is not None


def test_grouped_never_uploads_the_dominant_table_whole():
    """Only shards reach the device: the catalog's lineitem never holds a
    device column, no program keeps a shard's upload, and each base
    column is made once per grouped query."""
    catalog = t_catalog.TpchCatalog(sf=0.002, device="cpu")
    e = t_engine.Engine(catalog, device="cpu")
    lineitem = catalog.table("lineitem")
    made = []
    host_column = lineitem.host_column

    def counted(name):
        made.append(name)
        return host_column(name)

    lineitem.host_column = counted
    got = e.compile_grouped(Q1_SHAPE, n_groups=4)
    out = got().to_pandas()
    assert lineitem._cache == {}
    assert sorted(made) == ["l_extendedprice", "l_linestatus",
                            "l_quantity", "l_returnflag", "l_shipdate"]
    for cq in got._programs.values():
        assert cq.inputs is None
    assert_frames_match(out, e.sql(Q1_SHAPE).to_pandas(), ordered=True)


def test_grouped_rediscovers_a_shard_that_outgrows_the_first():
    """A filter that passes no row of the first shard and many of the
    last: the last shard's run overflows the first shard's capacities,
    raises, and is discovered anew -- never truncated."""
    catalog = t_catalog.TpchCatalog(sf=0.002, device="cpu")
    e = t_engine.Engine(catalog, device="cpu")
    n = catalog.table("lineitem").num_rows
    last = int(catalog.table("lineitem").host_column("l_orderkey").data[
        n * 3 // 4])
    sql = ("select l_linestatus, count(*) c, sum(l_quantity) q "
           f"from lineitem where l_orderkey >= {last} "
           "group by l_linestatus order by l_linestatus")
    tq = e.compile_grouped(sql, n_groups=4)
    assert_frames_match(tq().to_pandas(), e.sql(sql).to_pandas(),
                        ordered=True)
    assert tq.info["runs"] == 4 and tq.info["programs"] <= 2


@pytest.fixture(scope="module")
def q18():
    je = j_engine.Engine(j_catalog.TpchCatalog(sf=0.01))
    te = t_engine.Engine(t_catalog.TpchCatalog(sf=0.01, device="cpu"),
                         device="cpu")
    return je, te


def test_q18_is_refused_where_the_reference_answers_wrongly_c6(q18):
    je, te = q18
    sql = QUERIES[18]
    with pytest.raises(ValueError, match="exactly one scan of lineitem"):
        te.compile_grouped(sql, n_groups=4)
    right = te.sql(sql).to_pandas()
    assert len(right) == 1
    assert_frames_match(right, je.sql(sql).to_pandas(), ordered=True)
    # the JAX package's grouped answer: its HAVING saw per-shard sums
    wrong = je.compile_grouped(sql, n_groups=4)().to_pandas()
    assert len(wrong) == 3
    assert sorted(wrong.iloc[:, 5].astype(float)) != \
        sorted(right.iloc[:, 5].astype(float))


@pytest.mark.parametrize("plan_sql,why", [
    ("select o_orderkey, count(*) from orders left join lineitem "
     "on o_orderkey = l_orderkey group by o_orderkey",
     r"through Join left \(child 1\)"),
    ("select count(*) from orders where o_orderkey in "
     "(select l_orderkey from lineitem where l_quantity > 49)",
     r"through Join semi \(child 1\)"),
    ("select sum(c) from (select l_orderkey, count(*) c from lineitem "
     "group by l_orderkey) t", "through Aggregate"),
])
def test_grouped_refuses_plans_a_shard_would_change(engines, plan_sql, why):
    _, te = engines
    with pytest.raises(ValueError, match=why):
        te.compile_grouped(plan_sql, n_groups=3)


def test_grouped_q3_widens_and_guards_key_ranges_c7(engines):
    """C7: grouped TPC-H Q3 groups by ``l_orderkey``; the JAX package
    compiles each shard's partial with the first shard's key range, so
    later shards' keys clamp and collide, and its top row is wrong."""
    je, te = engines
    sql = QUERIES[3]
    right = te.sql(sql).to_pandas()
    got = te.compile_grouped(sql, n_groups=3)().to_pandas()
    assert_frames_match(got, right, ordered=True)
    assert_frames_match(right, je.sql(sql).to_pandas(), ordered=True)
    wrong = je.compile_grouped(sql, n_groups=3)().to_pandas()
    assert list(wrong.l_orderkey) != list(right.l_orderkey)
