"""UNION / INTERSECT / EXCEPT / ROLLUP / GROUPING SETS, FULL OUTER JOIN and
the semi/anti joins of IN and NOT EXISTS through the port's engine on the
CPU, eager and compiled, against the JAX package's single-device
``Engine.sql`` at SF 0.01, and the plans against its ``Engine.explain``.

Integers, decimals, dates, dictionary values, validity and row order exact;
doubles to 1e-6 relative (summation order differs).  Statements without an
ORDER BY are compared as sorted row lists.
"""

import pytest
import torch

import presto1_tpu.exec.catalog as j_catalog
import presto1_tpu.exec.engine as j_engine
import presto1_tpu_torch.exec.catalog as t_catalog
import presto1_tpu_torch.exec.engine as t_engine
import presto1_tpu_torch.exec.executor as t_executor
from presto1_tpu_torch.sql.logical import Union

from torch_parity import assert_batches_equal, no_host_sync

torch.set_num_threads(1)

UNION_COUNT = ("select count(*) from (select n_regionkey from nation "
               "union all select r_regionkey from region) t")
UNION_DISTINCT = ("select n_regionkey from nation union "
                  "select r_regionkey from region")

STATEMENTS = {
    "union_all_count": UNION_COUNT,
    "union_distinct": UNION_DISTINCT,
    "union_all_strings": "select n_name from nation union all "
                         "select r_name from region order by 1",
    "union_all_mixed_types": "select n_nationkey, n_name from nation "
                             "union all select r_regionkey * 1.5, "
                             "r_name from region order by 1, 2",
    "union_three_parts": "select c_nationkey k from customer where "
                         "c_acctbal > 9000 union all select s_nationkey "
                         "from supplier union all select n_nationkey from "
                         "nation order by 1",
    "intersect": "select n_regionkey from nation intersect "
                 "select r_regionkey from region",
    "except": "select n_nationkey from nation except "
              "select r_regionkey from region",
    "rollup": "select l_returnflag f, l_linestatus s, count(*) c, "
              "sum(l_quantity) q from lineitem "
              "group by rollup(l_returnflag, l_linestatus)",
    "cube": "select o_orderstatus st, o_orderpriority pr, count(*) c "
            "from orders group by cube(o_orderstatus, o_orderpriority)",
    "grouping_sets": "select c_mktsegment m, c_nationkey n, count(*) c "
                     "from customer group by grouping sets "
                     "((c_mktsegment), (c_nationkey), ())",
    "rollup_having_order": "select l_returnflag f, l_linestatus s, "
                           "count(*) c from lineitem group by "
                           "rollup(l_returnflag, l_linestatus) "
                           "having count(*) > 100 order by c desc",
    "full_join_cross_residual": "select c_custkey, o_orderkey from customer "
                                "full outer join orders on c_custkey = "
                                "o_custkey and o_totalprice > "
                                "c_acctbal * 100",
    "full_join_one_side_residual": "select n_name, r_name from nation full "
                                   "join region on n_regionkey = "
                                   "r_regionkey and r_regionkey < 3",
    "full_join_plain": "select s_suppkey, c_custkey from supplier full join "
                       "customer on s_suppkey = c_custkey",
    "left_join_residual": "select c_custkey, o_orderkey from customer left "
                          "join orders on c_custkey = o_custkey and "
                          "o_totalprice > 100000 order by c_custkey, "
                          "o_orderkey",
    "right_join_residual": "select o_orderkey, c_custkey from orders right "
                           "join customer on c_custkey = o_custkey and "
                           "o_totalprice > 100000 order by c_custkey, "
                           "o_orderkey",
    "in_subquery": "select count(*) from orders where o_custkey in "
                   "(select c_custkey from customer where c_acctbal > 5000)",
    "not_in_subquery": "select count(*) from customer where c_custkey not in "
                       "(select o_custkey from orders)",
    "not_exists": "select count(*) from customer where not exists "
                  "(select * from orders where o_custkey = c_custkey)",
    "exists_residual": "select o_orderpriority, count(*) from orders where "
                       "exists (select * from lineitem where l_orderkey = "
                       "o_orderkey and l_commitdate < l_receiptdate) "
                       "group by o_orderpriority order by 1",
    "wide_key_left_join": "select n1.n_name, n2.n_nationkey from nation n1 "
                          "left join nation n2 on n1.n_name = n2.n_name "
                          "and n1.n_comment = n2.n_comment and "
                          "n2.n_nationkey > 10 order by n1.n_nationkey",
    "scalar_subquery": "select count(*) from part where p_retailprice > "
                       "(select avg(p_retailprice) from part)",
}
MODES = ["sql", "compiled_call", "block_run"]


@pytest.fixture(scope="module")
def engines():
    jc = j_catalog.TpchCatalog("tiny")
    tc = t_catalog.TpchCatalog("tiny", device="cpu")
    return j_engine.Engine(jc), t_engine.Engine(tc, device="cpu")


@pytest.fixture(scope="module")
def references():
    return {}


def _reference(engines, references, name):
    if name not in references:
        references[name] = engines[0].sql(STATEMENTS[name])
    return references[name]


def _run(te, sql, mode):
    if mode == "sql":
        return te.sql(sql)
    cq = te.compile(sql)
    if mode == "block_run":
        assert cq.block_run(reps=2) == cq().num_rows
    return cq()


def _sorted_rows(batch):
    key = lambda r: tuple((x is None, str(x)) for x in r)  # noqa: E731
    return sorted(batch.to_pylist(), key=key)


def test_the_planner_fault_is_repaired(engines):
    """Aggregate over UNION ALL and UNION DISTINCT plan through
    ``split_aggregate``, which the port lacked (``exec/dist_engine.py``):
    both raised ModuleNotFoundError before it was ported."""
    je, te = engines
    for sql in (UNION_COUNT, UNION_DISTINCT):
        assert te.explain(sql) == je.explain(sql)
        assert _sorted_rows(te.sql(sql)) == _sorted_rows(je.sql(sql))
    assert te.sql(UNION_COUNT).to_pylist() == [(30,)]


@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("name", sorted(STATEMENTS))
def test_statement_matches_reference(engines, references, name, mode):
    _, te = engines
    sql = STATEMENTS[name]
    want = _reference(engines, references, name)
    got = _run(te, sql, mode)
    if "order by" in sql:
        assert_batches_equal(want, got, f"{name} {mode}")
    else:
        assert [str(c.type) for c in got.columns.values()] == \
            [str(c.type) for c in want.columns.values()]
        assert _sorted_rows(got) == _sorted_rows(want), f"{name} {mode}"


@pytest.mark.parametrize("name", sorted(STATEMENTS))
def test_plan_matches_reference(engines, name):
    je, te = engines
    assert te.explain(STATEMENTS[name]) == je.explain(STATEMENTS[name])


def test_union_goes_through_dyncopy_once_per_run(engines, monkeypatch):
    """Every Union moves its parts with one call of ``concat_rows`` (one
    kernel launch per row width on a card), eager and in every compiled
    run; the merged dictionaries and remaps are made once per plan."""
    _, te = engines
    calls = []
    real = t_executor.concat_rows

    def spy(columns, counts, capacity):
        calls.append(len(columns))
        return real(columns, counts, capacity)

    monkeypatch.setattr(t_executor, "concat_rows", spy)
    sql = STATEMENTS["union_all_strings"]
    te.sql(sql)
    assert len(calls) == 1
    cq = te.compile(sql)  # one discovery run
    assert len(calls) == 2
    union = [p for p in cq.record
             if isinstance(t_executor._node_at(cq.plan, p), Union)]
    rec = cq.record[union[0]]
    dicts = rec[("dictionaries", "cpu")]
    remaps = next(iter(dicts.values()))[1]
    cq.block_run(reps=3)
    assert len(calls) == 5
    # the replay reused the discovery's uploaded remaps
    assert next(iter(rec[("dictionaries", "cpu")].values()))[1] is remaps


def test_union_of_null_column_merges_into_the_dictionary(engines):
    """A branch that projects NULL for a varchar column (ROLLUP's grand
    total) carries no dictionary: its rows come out NULL under the merged
    dictionary."""
    je, te = engines
    sql = ("select n_name, r_name, count(*) c from nation, region "
           "where n_regionkey = r_regionkey "
           "group by rollup(r_name, n_name) order by 2, 1")
    for got in (te.sql(sql), te.compile(sql)()):
        assert_batches_equal(je.sql(sql), got)
        assert sum(r[0] is None for r in got.to_pylist()) == 6
        assert got.to_pylist()[-1] == (None, None, 25)


def test_full_join_capacity_guard_trips(engines):
    """A compiled FULL join whose parts outgrew discovery raises after the
    one readback instead of dropping rows."""
    _, te = engines
    cq = te.compile(STATEMENTS["full_join_plain"])
    n = cq().num_rows
    path = next(p for p, r in cq.record.items() if "full_capacity" in r)
    cq.record[path]["full_capacity"] = 128  # as if discovery saw fewer
    cq._caps = {k: min(v, 128) if k == path else v
                for k, v in cq._caps.items()}
    assert n > 128
    with pytest.raises(t_executor.ExecError, match="overflow"):
        cq()


def test_union_capacity_guard_trips(engines):
    _, te = engines
    cq = te.compile(STATEMENTS["union_three_parts"])
    assert cq().num_rows > 128
    path = next(p for p in cq.record
                if isinstance(t_executor._node_at(cq.plan, p), Union))
    cq.record[path]["capacity"] = 128
    with pytest.raises(t_executor.ExecError, match="overflow"):
        cq.block_run(reps=2)


def test_lookup_tables_are_bound_once_per_plan(engines):
    """String predicates fold into DictLookups whose tables are uploaded in
    the discovery run and kept in the plan's record: compiled runs evaluate
    the same device tensors and add no binding of their own."""
    from presto1_tpu_torch.expr.ir import DictLookup, walk

    je, te = engines
    sql = STATEMENTS["union_all_strings"].replace(
        "from nation", "from nation where n_name like '%A%'")
    cq = te.compile(sql)
    bound = {(p, k[1]): e for p, r in cq.record.items() for k, e in r.items()
             if isinstance(k, tuple) and k[0] == "bound"}
    lookups = [d for e in bound.values() for d in walk(e)
               if isinstance(d, DictLookup)]
    assert lookups and all(isinstance(d.table, torch.Tensor)
                           and d.table.device == cq.device for d in lookups)
    first = cq()
    assert first.to_pylist() == je.sql(sql).to_pylist()
    again = {(p, k[1]): e for p, r in cq.record.items() for k, e in r.items()
             if isinstance(k, tuple) and k[0] == "bound"}
    assert again.keys() == bound.keys() \
        and all(again[k] is bound[k] for k in bound)
    assert_batches_equal(cq(), first)


def test_dynamic_filter_of_an_empty_build_masks_every_row(engines):
    _, te = engines
    from presto1_tpu_torch.batch import RecordBatch
    from presto1_tpu_torch.testing.parity import batch_from_numpy_parts
    import numpy as np

    lb = batch_from_numpy_parts(
        {"k": {"data": np.arange(200), "type": "bigint"}}, 200, device="cpu")
    rb = batch_from_numpy_parts(
        {"b": {"data": np.arange(128), "type": "bigint"}}, 0, device="cpu")
    ex = t_executor.Executor(te.catalog, device="cpu")
    mask = ex._dynamic_filter(lb, rb, ["k"], ["b"], None)
    assert mask.dtype == torch.bool and not mask.any()
    rb = RecordBatch(rb.columns, 5)
    mask = ex._dynamic_filter(lb, rb, ["k"], ["b"], None)
    assert mask.sum() == 5
    off = t_executor.Executor(te.catalog, device="cpu",
                              dynamic_filtering=False)
    assert off._dynamic_filter(lb, rb, ["k"], ["b"], None) is None


@pytest.mark.parametrize("name", ["union_all_strings", "union_distinct",
                                  "rollup", "full_join_cross_residual",
                                  "not_exists", "exists_residual",
                                  "wide_key_left_join", "scalar_subquery"])
def test_compiled_run_never_waits_for_the_host(engines, monkeypatch, name):
    """Between its start and its one readback a compiled run reads nothing
    back and uploads nothing (DictLookup tables included)."""
    _, te = engines
    cq = te.compile(STATEMENTS[name])
    n = cq().num_rows
    no_host_sync(monkeypatch)
    _, _, num_rows, _ = cq._run()
    monkeypatch.undo()
    assert int(num_rows) == n
