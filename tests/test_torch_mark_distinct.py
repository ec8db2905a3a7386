"""Several DISTINCT aggregates in one query through the port's MarkDistinct
(``Executor._x_MarkDistinct``, the ``__mask`` function) against the JAX
package: the statements of ``tests/test_mark_distinct.py`` through both
engines at SF 0.01, eager and compiled, and MarkDistinct's flags on seeded
batches with NULL keys and dead rows.

Integers, dictionary values and validity exact; doubles to 1e-6 relative.
Statements without an ORDER BY are compared as sorted row lists.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

import presto1_tpu.exec.catalog as j_catalog
import presto1_tpu.exec.engine as j_engine
import presto1_tpu.exec.executor as j_executor
import presto1_tpu_torch.exec.catalog as t_catalog
import presto1_tpu_torch.exec.engine as t_engine
import presto1_tpu_torch.exec.executor as t_executor
from presto1_tpu.batch import Column as JColumn, RecordBatch as JRecordBatch
from presto1_tpu.exec.memory_catalog import MemoryTable as JMemoryTable
from presto1_tpu_torch.batch import from_numpy
from presto1_tpu_torch.exec.memory_catalog import MemoryTable as TMemoryTable
from presto1_tpu_torch.sql.logical import MarkDistinct

from torch_parity import assert_batches_equal, no_host_sync

torch.set_num_threads(1)

STATEMENTS = {
    "two_count_distinct_grouped":
        "select l_returnflag f, count(distinct l_partkey) p, "
        "count(distinct l_suppkey) s from lineitem "
        "group by l_returnflag order by f",
    "three_distinct_global":
        "select count(distinct l_partkey) p, count(distinct l_suppkey) s, "
        "count(distinct l_orderkey) o from lineitem",
    "distinct_mixed_with_plain":
        "select l_linestatus f, count(distinct l_partkey) p, "
        "count(distinct l_suppkey) s, sum(l_quantity) q, count(*) c "
        "from lineitem group by l_linestatus order by f",
    "sum_avg_distinct":
        "select l_returnflag f, sum(distinct l_quantity) sq, "
        "avg(distinct l_quantity) aq from lineitem "
        "group by l_returnflag order by f",
    "multiple_approx_distinct_exact_fallback":
        "select approx_distinct(l_partkey) p, approx_distinct(l_suppkey) s "
        "from lineitem",
    "compiled_multiple_distinct":
        "select l_returnflag f, count(distinct l_partkey) p, "
        "count(distinct l_suppkey) s from lineitem group by l_returnflag",
}
SHARED = ("select count(distinct l_partkey), sum(distinct l_partkey), "
          "count(distinct l_suppkey) from lineitem")


@pytest.fixture(scope="module")
def engines():
    return (j_engine.Engine(j_catalog.TpchCatalog(sf=0.01)),
            t_engine.Engine(t_catalog.TpchCatalog(sf=0.01, device="cpu"),
                            device="cpu"))


def _sorted_rows(batch):
    key = lambda r: tuple((x is None, str(x)) for x in r)  # noqa: E731
    return sorted(batch.to_pylist(), key=key)


def _compare(want, got, sql, what):
    if "order by" in sql:
        assert_batches_equal(want, got, what)
    else:
        assert _sorted_rows(got) == _sorted_rows(want), what


@pytest.mark.parametrize("mode", ["sql", "compiled"])
@pytest.mark.parametrize("name", sorted(STATEMENTS))
def test_statement_matches_reference(engines, name, mode, monkeypatch):
    je, te = engines
    sql = STATEMENTS[name]
    want = je.sql(sql)
    if mode == "sql":
        got = te.sql(sql)
    else:
        cq = te.compile(sql)
        got = cq()
        with monkeypatch.context() as m:
            no_host_sync(m)
            cq._run()
    _compare(want, got, sql, f"{name} {mode}")


def test_same_arg_shares_marker(engines):
    """One MarkDistinct, two markers (count and sum of l_partkey share
    one), as in the reference's plan."""
    je, te = engines
    assert te.explain(SHARED) == je.explain(SHARED)
    mds = []

    def walk(n):
        if isinstance(n, MarkDistinct):
            mds.append(n)
        for c in n.children:
            walk(c)

    walk(te.plan(SHARED))
    assert len(mds) == 1 and len(mds[0].markers) == 2
    assert te.sql(SHARED).to_pylist() == je.sql(SHARED).to_pylist()


def _null_tables():
    rng = np.random.default_rng(7)
    n = 5000
    # -1 sentinels become NULL through nullif() in the query
    g = np.where(rng.random(n) < 0.1, -1,
                 rng.integers(0, 5, n)).astype(np.int64)
    a = np.where(rng.random(n) < 0.2, -1,
                 rng.integers(0, 40, n)).astype(np.int64)
    b = np.where(rng.random(n) < 0.2, -1,
                 rng.integers(0, 15, n)).astype(np.int64)
    return {"g": g, "a": a, "b": b}


NULLS_SQL = ("select nullif(g, -1) gg, count(distinct nullif(a, -1)) ca, "
             "count(distinct nullif(b, -1)) cb from t "
             "group by nullif(g, -1) order by gg")


@pytest.mark.parametrize("mode", ["sql", "compiled"])
def test_nulls_in_values_and_group(mode):
    """NULL group keys and NULL marker keys, from a memory table written
    with the same numpy columns in both packages."""
    from presto1_tpu.types import BIGINT as JB
    from presto1_tpu_torch.types import BIGINT as TB

    cols = _null_tables()
    je = j_engine.Engine(j_catalog.TpchCatalog(sf=0.001))
    jt = JMemoryTable("t", [(c, JB) for c in cols])
    jt.append(JRecordBatch({c: JColumn(jnp.asarray(v), JB)
                            for c, v in cols.items()}, 5000))
    je.catalog.tables["t"] = jt
    te = t_engine.Engine(t_catalog.TpchCatalog(sf=0.001, device="cpu"),
                         device="cpu")
    tt = TMemoryTable("t", [(c, TB) for c in cols], device="cpu")
    tt.append(from_numpy(cols, {c: TB for c in cols}, device="cpu"))
    te.catalog.tables["t"] = tt
    want = je.sql(NULLS_SQL)
    got = te.sql(NULLS_SQL) if mode == "sql" else te.compile(NULLS_SQL)()
    assert_batches_equal(want, got, mode)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_markers_match_reference(seed):
    """MarkDistinct's first-occurrence flags over NULL-bearing group and
    marker keys and dead rows past the row count (which must never take a
    first occurrence): the JAX package's routes them back by a second sort,
    the port by a scatter through the permutation; the flags are equal."""
    from presto1_tpu.expr import ir as j_ir
    from presto1_tpu.sql.logical import (MarkDistinct as JMD,
                                         SingleRow as JSR)
    from presto1_tpu_torch.expr import ir as t_ir
    from presto1_tpu_torch.sql.logical import SingleRow as TSR

    from torch_parity import both_batches

    rng = np.random.default_rng(seed)
    n, live = 300, 260
    spec = {
        "g": (rng.integers(0, 4, n), rng.random(n) < 0.9, "bigint"),
        "k": (rng.integers(-3, 9, n), rng.random(n) < 0.8, "bigint"),
        "j": (rng.integers(0, 3, n).astype(np.int32), None, "integer"),
    }
    jb, tb = both_batches(spec, num_rows=live)
    outs = []
    for ex_mod, MD, SR, ir, b in (
            (j_executor, JMD, JSR, j_ir, jb),
            (t_executor, MarkDistinct, TSR, t_ir, tb)):
        from presto1_tpu.types import BIGINT as JB, INTEGER as JI
        from presto1_tpu_torch.types import BIGINT as TB, INTEGER as TI

        B, I = (JB, JI) if ir is j_ir else (TB, TI)
        node = MD(SR(), ["g"], [("m0", [ir.ColumnRef("k", B)]),
                                ("m1", [ir.ColumnRef("k", B),
                                        ir.ColumnRef("j", I)])])
        kw = {} if ex_mod is j_executor else {"device": "cpu"}
        ex = ex_mod.Executor(None, stubs={(0,): b}, **kw)
        outs.append(ex.execute(node))
    jo, to = outs
    for m in ("m0", "m1"):
        want = np.asarray(jo[m].data)[:live]
        got = to[m].data.numpy()[:live]
        np.testing.assert_array_equal(got, want, err_msg=m)


@pytest.mark.parametrize("mode", ["sql", "compiled"])
def test_distinct_varchar_beside_another_distinct_c15(engines, mode):
    """Two DISTINCT aggregates, one over a varchar: the JAX package folds
    the aggregate's ``__mask`` over the string column into a dictionary
    lookup and raises at its host string evaluator; the port keeps the
    mask on the device and answers the pandas counts."""
    je, te = engines
    sql = ("select n_regionkey r, count(distinct n_name) a, "
           "count(distinct substr(n_name, 1, 1)) b from nation "
           "group by n_regionkey order by r")
    with pytest.raises(NotImplementedError, match="__mask"):
        je.sql(sql)
    got = te.sql(sql) if mode == "sql" else te.compile(sql)()
    df = te.catalog.table("nation").batch(
        ["n_regionkey", "n_name"]).to_pandas()
    df["f"] = df.n_name.str[:1]
    want = df.groupby("n_regionkey").agg(a=("n_name", "nunique"),
                                         b=("f", "nunique"))
    assert got.to_pylist() == [(int(r), int(x.a), int(x.b))
                               for r, x in want.iterrows()]
