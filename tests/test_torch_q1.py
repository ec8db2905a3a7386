"""The slice as a whole: TPC-H Q1 and the revenue view of Q15 (and a few
more grouped / ordered statements) through the port's engine on the CPU,
eager and compiled, against the JAX package's single-device ``Engine.sql``
and the pandas oracle, at SF 0.01.

Integers, decimals, dates, dictionary values, validity and row order exact;
doubles to 1e-6 relative (summation order differs).
"""

import numpy as np
import pytest
import torch

import presto1_tpu.exec.catalog as j_catalog
import presto1_tpu.exec.engine as j_engine
import presto1_tpu_torch.exec.catalog as t_catalog
import presto1_tpu_torch.exec.engine as t_engine
import presto1_tpu_torch.exec.executor as t_executor
from presto1_tpu_torch.ops.kernels import (
    dense_group_agg as D, gather as G, scatter as S)
from presto1_tpu_torch.sql.logical import Aggregate, Sort
from presto1_tpu_torch.testing.verifier import compare_frames
from presto1_tpu_torch.tpch.queries import Q15_REVENUE_VIEW, QUERIES

from torch_parity import assert_batches_equal
from tpch_oracle import ORACLE, D as day, rev

# the tests are tiny; one thread keeps torch's pool from competing with the
# other test workers' 8-device CPU meshes for the same cores
torch.set_num_threads(1)


@pytest.fixture(scope="module")
def engines():
    jc = j_catalog.TpchCatalog("tiny")
    tc = t_catalog.TpchCatalog("tiny", device="cpu")
    return j_engine.Engine(jc), t_engine.Engine(tc, device="cpu")


def _run(te, sql, mode):
    if mode == "sql":
        return te.sql(sql)
    cq = te.compile(sql)
    if mode == "block_run":
        assert cq.block_run(reps=2) == cq().num_rows
    return cq()


def _frames(te, columns):
    return {"lineitem": te.catalog.table("lineitem").batch(
        list(columns)).to_pandas()}


MODES = ["sql", "compiled_call", "block_run"]


@pytest.mark.parametrize("column", ["l_returnflag", "l_linestatus", "l_tax",
                                    "l_suppkey"])
def test_dbgen_columns_equal_reference(engines, column):
    je, te = engines
    jc = je.catalog.table("lineitem").column(column)
    tc = te.catalog.table("lineitem").column(column)
    assert str(jc.type) == str(tc.type)
    np.testing.assert_array_equal(np.asarray(jc.data), tc.data.numpy())
    if jc.dictionary is not None:
        np.testing.assert_array_equal(jc.dictionary, tc.dictionary)


@pytest.mark.parametrize("mode", MODES)
def test_q1_matches_reference_and_oracle(engines, mode):
    je, te = engines
    want = je.sql(QUERIES[1])
    before = (D.LAUNCHES, G.LAUNCHES, S.LAUNCHES)
    got = _run(te, QUERIES[1], mode)
    # CPU tensors never launch a kernel
    assert (D.LAUNCHES, G.LAUNCHES, S.LAUNCHES) == before
    assert_batches_equal(want, got, mode)
    assert got.num_rows == 4
    assert [r[:2] for r in got.to_pylist()] == \
        [("A", "F"), ("N", "F"), ("N", "O"), ("R", "F")]
    assert [str(c.type) for c in got.columns.values()] == [
        "varchar", "varchar", "decimal(38,2)", "decimal(38,2)",
        "decimal(38,4)", "decimal(38,6)", "double", "double", "double",
        "bigint"]
    frames = _frames(te, ("l_returnflag", "l_linestatus", "l_quantity",
                          "l_extendedprice", "l_discount", "l_tax",
                          "l_shipdate"))
    assert compare_frames(got.to_pandas(), ORACLE[1](frames)) is None


def _view_oracle(frames):
    li = frames["lineitem"]
    li = li[(li.l_shipdate >= day("1996-01-01"))
            & (li.l_shipdate < day("1996-04-01"))]
    g = li.assign(revenue=rev(li)).groupby(
        "l_suppkey", as_index=False).revenue.sum()
    return g.sort_values("l_suppkey").reset_index(drop=True)


@pytest.mark.parametrize("mode", MODES)
def test_q15_view_matches_reference_and_oracle(engines, mode):
    je, te = engines
    want = je.sql(Q15_REVENUE_VIEW)
    got = _run(te, Q15_REVENUE_VIEW, mode)
    assert_batches_equal(want, got, mode)
    assert got.names == ["supplier_no", "total_revenue"]
    assert got.num_rows == 100  # every supplier of SF 0.01 ships in a quarter
    keys = got["supplier_no"].data[:100]
    assert torch.equal(keys, torch.arange(1, 101))
    assert str(got["total_revenue"].type) == "decimal(38,4)"
    frames = _frames(te, ("l_suppkey", "l_extendedprice", "l_discount",
                          "l_shipdate"))
    assert compare_frames(got.to_pandas(), _view_oracle(frames)) is None


def test_explain_equals_reference(engines):
    je, te = engines
    for sql in (QUERIES[1], Q15_REVENUE_VIEW):
        assert te.explain(sql) == je.explain(sql)


def test_q6_still_answers(engines):
    je, te = engines
    assert_batches_equal(je.sql(QUERIES[6]), te.sql(QUERIES[6]), "q6")
    assert te.compile(QUERIES[6])().to_pylist() == [(1263258.0823,)]


STATEMENTS = {
    "group_one_flag": "select l_returnflag, count(*), sum(l_quantity) from "
                      "lineitem group by l_returnflag order by l_returnflag",
    "group_no_order": "select l_linestatus, max(l_shipdate), "
                      "min(l_extendedprice) from lineitem "
                      "group by l_linestatus",
    "group_by_order_key": "select l_orderkey, sum(l_quantity), count(*) "
                          "from lineitem group by l_orderkey "
                          "order by l_orderkey limit 20",
    "two_keys_many_groups": "select l_suppkey, l_linenumber, "
                            "avg(l_extendedprice), count(l_tax) from "
                            "lineitem where l_quantity < 10 "
                            "group by l_suppkey, l_linenumber "
                            "order by l_suppkey desc, l_linenumber limit 50",
    "minmax_by_group": "select l_shipmode, min(l_discount), max(l_tax), "
                       "min(l_shipdate), avg(l_discount) from lineitem "
                       "group by l_shipmode order by l_shipmode",
    "double_sums": "select l_linenumber, sum(cast(l_quantity as double)), "
                   "avg(cast(l_extendedprice as double)) from lineitem "
                   "group by l_linenumber order by l_linenumber",
    "order_desc_limit": "select l_orderkey, l_extendedprice from lineitem "
                        "where l_shipdate < date '1992-02-01' "
                        "order by l_extendedprice desc, l_orderkey limit 15",
    "order_offset": "select o_orderkey, o_totalprice from orders "
                    "where o_orderdate < date '1992-01-20' "
                    "order by o_totalprice desc offset 3 limit 5",
    "empty_groups": "select l_suppkey, sum(l_quantity) from lineitem "
                    "where l_shipdate < date '1900-01-01' "
                    "group by l_suppkey order by l_suppkey",
    "orders_by_priority": "select o_orderpriority, count(*), "
                          "sum(o_totalprice) from orders "
                          "group by o_orderpriority order by o_orderpriority",
}


@pytest.mark.parametrize("compiled", [False, True])
@pytest.mark.parametrize("name", sorted(STATEMENTS))
def test_statement_matches_reference(engines, name, compiled):
    je, te = engines
    sql = STATEMENTS[name]
    want = je.sql(sql)
    got = te.compile(sql)() if compiled else te.sql(sql)
    assert_batches_equal(want, got, name)
    assert compare_frames(got.to_pandas(), want.to_pandas()) is None


def test_compiled_records_and_fragments(engines):
    """Aggregate and Sort each root a fragment; discovery records the key
    ranges, the group capacity and the clustered flag the replay uses."""
    _, te = engines
    plan = te.plan(QUERIES[1])
    roots = t_executor._fragment_roots(plan)
    assert [type(t_executor._node_at(plan, r)).__name__ for r in roots] == \
        ["Output", "Sort", "Aggregate"]
    cq = te.compile(QUERIES[1])
    agg_path = roots[2]
    rec = cq.record[agg_path]
    assert rec["ranges"] == [(0, 2), (0, 1)]
    assert rec["max_groups"] == 128 and rec["clustered"] is False
    assert len(cq._stages) == 3
    # one readback closes a run: counts and flags stay device tensors
    data, validity, num_rows, oks = cq._run()
    assert isinstance(num_rows, torch.Tensor) and num_rows.dim() == 0
    assert oks and all(isinstance(o, torch.Tensor) for o in oks)
    assert cq._read([cq._pair(num_rows, oks)]) == 4


def test_clustered_is_recorded_and_sticky(engines):
    """lineitem is stored in l_orderkey order: grouping by it takes the
    clustered path, but not under a fused filter mask, and a recorded False
    stays False."""
    _, te = engines
    sql = "select l_orderkey, count(*) from lineitem group by l_orderkey"
    plan = te.plan(sql)
    path = next(r for r in t_executor._fragment_roots(plan)
                if isinstance(t_executor._node_at(plan, r), Aggregate))
    ex = t_executor.Executor(te.catalog, device="cpu")
    out = ex.execute(plan)
    assert ex.record[path]["clustered"] is True
    assert ex.chains[path] == [{t_executor._node_at(plan, path).group[0]}]
    masked = "select l_orderkey, count(*) from lineitem " \
             "where l_quantity < 10 group by l_orderkey"
    mplan = te.plan(masked)
    mpath = next(r for r in t_executor._fragment_roots(mplan)
                 if isinstance(t_executor._node_at(mplan, r), Aggregate))
    mex = t_executor.Executor(te.catalog, device="cpu")
    mex.execute(mplan)
    assert mex.record[mpath]["clustered"] is False
    ex.record[path]["clustered"] = False  # sticky across eager reruns
    again = ex.execute(plan)
    assert ex.record[path]["clustered"] is False
    assert again.to_pylist() == out.to_pylist()


def test_sort_chain_is_derived(engines):
    _, te = engines
    plan = te.plan(Q15_REVENUE_VIEW)
    ex = t_executor.Executor(te.catalog, device="cpu")
    ex.execute(plan)
    sort_path = next(r for r in t_executor._fragment_roots(plan)
                     if isinstance(t_executor._node_at(plan, r), Sort))
    key = t_executor._node_at(plan, sort_path).keys[0][0].name
    assert ex.chains[sort_path] == [{key}]


def test_group_capacity_guard_raises_after_the_one_readback(engines):
    """A compiled plan whose groups outgrew discovery raises ExecError."""
    _, te = engines
    cq = te.compile("select l_suppkey, count(*) from lineitem "
                    "group by l_suppkey")
    agg_path = next(p for p, r in cq.record.items() if "max_groups" in r)
    assert cq.record[agg_path]["max_groups"] == 128
    assert cq().num_rows == 100
    cq.record[agg_path]["max_groups"] = 64  # as if discovery saw fewer
    with pytest.raises(t_executor.ExecError, match="overflow"):
        cq()


def test_later_plan_nodes_still_raise(engines):
    """Every plan node of the reference's executor runs in the port now
    (MarkDistinct was the last to raise): no list of later nodes is left,
    and two distinct aggregates answer as the reference does."""
    je, te = engines
    sql = ("select count(distinct l_partkey), count(distinct l_suppkey) "
           "from lineitem")
    assert te.sql(sql).to_pylist() == je.sql(sql).to_pylist()
    assert not hasattr(t_executor, "_LATER_NODES")
    for node in ("Sort", "Join", "Union", "WindowNode", "Unnest",
                 "MarkDistinct", "MergeSorted"):
        assert hasattr(t_executor.Executor, f"_x_{node}")
    # the whole of Q15 (the view joined to supplier) runs since joins came
    assert te.sql(QUERIES[15]).num_rows == 1
