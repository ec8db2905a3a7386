"""The statement surface beyond queries in the port (``Engine.
execute_statement``, ``exec/memory_catalog.py``, ``exec/system_catalog.py``,
``spi/connector.py``, ``server/security.py``) against the JAX package on
the CPU at SF 0.001: the statements of ``tests/test_memory.py`` (DML),
``test_show_offset.py``, ``test_system.py``, ``test_connector_spi.py``, the
table cases of ``test_types_conformance.py``, the json and url cases of
``test_fn_breadth.py`` and the engine cases of ``test_security_proxy.py``,
through both packages.  Also the two reference defects the port does not
copy (ROADMAP C9: decimals written through a float64; C10: the query of a
CREATE TABLE AS or an INSERT runs outside the memory limit), nested columns
and MarkDistinct / Unnest through a spill, and the new modules importing
with jax blocked.
"""

import os
import subprocess
import sys

import numpy as np
import pytest
import torch

import presto1_tpu.exec.catalog as j_catalog
import presto1_tpu.exec.engine as j_engine
import presto1_tpu.exec.memory as j_memory
import presto1_tpu.exec.session as j_session
import presto1_tpu_torch.exec.catalog as t_catalog
import presto1_tpu_torch.exec.engine as t_engine
import presto1_tpu_torch.exec.memory as t_memory
import presto1_tpu_torch.exec.session as t_session

from torch_parity import assert_batches_equal

torch.set_num_threads(1)


def _engines(sf=0.001, session=None, **kw):
    js = ts = None
    if session is not None:
        js, ts = j_session.Session(), t_session.Session()
        for k, v in session.items():
            js.set(k, v)
            ts.set(k, v)
    return (j_engine.Engine(j_catalog.TpchCatalog(sf=sf), session=js),
            t_engine.Engine(t_catalog.TpchCatalog(sf=sf, device="cpu"),
                            session=ts, device="cpu", **kw))


def _rows(batch):
    key = lambda r: tuple((x is None, str(x)) for x in r)  # noqa: E731
    return sorted(batch.to_pylist(), key=key)


def _both(engines, sqls):
    """Each statement through both engines; the results of the last."""
    je, te = engines
    for sql in sqls:
        want, got = je.execute_statement(sql), te.execute_statement(sql)
    return want, got


# the statement sequences of the reference's tests, by test
SEQUENCES = {
    # tests/test_memory.py
    "create_insert_select": [
        "create table t (k bigint, name varchar, price decimal(10,2))",
        "insert into t values (1, 'ann', 9.50), (2, 'bob', 1.25)",
        "insert into t values (3, 'cy', -4.75)",
        "select k, name, price from t order by k",
        "select sum(price) s, count(*) c from t"],
    "ctas_and_join": [
        "create table topn as select n_nationkey k, n_name v from nation "
        "where n_regionkey = 1",
        "select count(*) c from customer, topn where c_nationkey = k"],
    "insert_from_query": [
        "create table sink (k bigint)",
        "insert into sink select o_orderkey from orders "
        "where o_orderkey < 100",
        "select count(*) from sink"],
    # tests/test_show_offset.py
    "show_tables": ["show tables"],
    "describe": ["describe nation"],
    "show_columns": ["show columns from region"],
    "show_session": ["show session"],
    "show_functions": ["show functions"],
    "show_schemas_catalogs": ["show schemas", "show catalogs"],
    "offset_with_order_by": [
        "select n_nationkey from nation order by n_nationkey "
        "offset 20 limit 3"],
    "offset_limit_order": [
        "select n_nationkey from nation order by n_nationkey "
        "limit 3 offset 5"],
    "offset_beyond": [
        "select n_nationkey from nation order by n_nationkey offset 30"],
    "offset_without_order": [
        "select count(*) c from (select o_orderkey from orders offset 100) t"],
    "offset_binds_to_whole_setop": [
        "select n_nationkey k from nation where n_nationkey < 3 union all "
        "select n_nationkey from nation where n_nationkey >= 22 "
        "order by k offset 4"],
    "offset_setop_without_order": [
        "select count(*) from (select n_nationkey k from nation union all "
        "select n_nationkey from nation offset 47) t"],
    # tests/test_types_conformance.py
    "timestamp_table_storage_and_agg": [
        "create table events (id bigint, at timestamp)",
        "insert into events values (1, timestamp '2021-06-01 10:00:00'), "
        "(2, timestamp '2021-06-01 11:30:00'), "
        "(3, timestamp '2021-05-31 23:59:59')",
        "select min(at) lo, max(at) hi, count(*) n from events",
        "select id from events order by at desc",
        "select date_trunc('day', at) d, count(*) n from events "
        "group by date_trunc('day', at) order by d"],
    "char_table": [
        "create table codes (c char(2), v bigint)",
        "insert into codes values ('US', 1), ('DE', 2), ('US', 3)",
        "select c, sum(v) s from codes where c = 'US' group by c"],
    # tests/test_fn_breadth.py
    "json_functions": [
        "create table docs (j varchar)",
        "insert into docs values "
        "('{\"a\": {\"b\": [1, 2, 3]}, \"n\": 7, \"s\": \"hi\"}'), "
        "('[10, 20]'), ('not json')",
        "select json_extract_scalar(j, '$.n') n, "
        "json_extract(j, '$.a.b') ab, "
        "json_extract_scalar(j, '$.a.b[1]') b1, "
        "json_extract_scalar(j, '$.s') s, "
        "json_array_length(j) al, json_size(j, '$.a.b') sz from docs"],
    "url_functions": [
        "create table urls (u varchar)",
        "insert into urls values "
        "('https://example.com:8443/path/x?q=1&r=2#frag')",
        "select url_extract_host(u) h, url_extract_path(u) p, "
        "url_extract_protocol(u) pr, url_extract_query(u) q, "
        "url_extract_fragment(u) f, url_extract_port(u) po, "
        "url_decode(url_encode(u)) rt from urls"],
    "explain": ["explain select count(*) from lineitem "
                "where l_quantity < 10"],
}


@pytest.mark.parametrize("case", sorted(SEQUENCES))
def test_statements_match_reference(case):
    engines = _engines()
    sqls = SEQUENCES[case]
    want, got = _both(engines, sqls)
    if case == "show_session":  # the descriptions are each package's own
        want, got = want.select(["name", "value"]), got.select(["name",
                                                               "value"])
    if "order by" in sqls[-1] or sqls[-1].startswith(("show", "describe",
                                                      "explain")):
        assert_batches_equal(want, got, case)
    else:
        assert _rows(got) == _rows(want), case


def test_insert_returns_rows_read_back_and_drop():
    engines = _engines()
    for e in engines:
        e.execute_statement("create table gone (x bigint)")
        assert e.execute_statement(
            "insert into gone select n_nationkey from nation"
        ).to_pylist() == [(25,)]
        assert e.execute_statement("select count(*) from gone"
                                   ).to_pylist() == [(25,)]
        e.execute_statement("drop table gone")
        assert "gone" not in [r[0] for r in e.execute_statement(
            "show tables").to_pylist()]
        with pytest.raises(Exception):
            e.execute_statement("select * from gone")


def test_memory_table_host_columns_equal_the_reference():
    """A CTAS of integer, decimal, date and dictionary columns stores the
    same host values in both packages (strings as codes into the values'
    sorted dictionary in the port, decoded objects in the JAX package)."""
    je, te = _engines()
    sql = ("create table m as select l_orderkey, l_quantity, "
           "l_extendedprice, l_shipdate, l_returnflag, l_comment "
           "from lineitem where l_linenumber < 4")
    je.execute_statement(sql)
    te.execute_statement(sql)
    jt, tt = je.catalog.table("m"), te.catalog.table("m")
    assert tt.num_rows == jt.num_rows > 0
    assert tt.device == te.device
    for c in jt.column_order:
        host = tt.host_column(c)
        if host.dictionary is not None:
            got = np.asarray(host.dictionary)[host.data]
            np.testing.assert_array_equal(got.astype(object),
                                          jt._data[c].astype(str))
            assert list(host.dictionary) == sorted(set(got))
        else:
            np.testing.assert_array_equal(host.data, jt._data[c])
            assert host.data.dtype == jt._data[c].dtype


# ---- C9: decimals are written exactly


def test_values_decimal_is_exact_c9():
    """``insert into t values (1234567890123456.78)`` into decimal(18,2):
    the port stores the unscaled 123456789012345678; the JAX package's
    ``_values_batch`` goes through float64 and stores ...680."""
    stored = {}
    for side, e in zip(("reference", "port"), _engines()):
        e.execute_statement("create table t (d decimal(18,2))")
        e.execute_statement("insert into t values (1234567890123456.78)")
        stored[side] = int(e.catalog.table("t")._data["d"][0])
    assert stored == {"reference": 123456789012345680,
                      "port": 123456789012345678}


def test_ctas_decimal_is_exact_c9():
    """A CTAS of ``cast(9007199254740993 as decimal(18,0))``: the port
    stores 9007199254740993 (what the same SELECT answers); the JAX
    package's ``MemoryTable.append`` rounds through float64 to
    9007199254740992."""
    sql = ("create table u as select cast(9007199254740993 as "
           "decimal(18,0)) d from nation where n_nationkey = 0")
    stored = {}
    for side, e in zip(("reference", "port"), _engines()):
        e.execute_statement(sql)
        stored[side] = int(e.catalog.table("u")._data["d"][0])
        assert int(e.sql("select cast(9007199254740993 as decimal(18,0)) "
                         "d").columns["d"].data[0]) == 9007199254740993
    assert stored == {"reference": 9007199254740992,
                      "port": 9007199254740993}


def test_values_decimal_rounds_half_away_from_zero():
    _, te = _engines()
    te.execute_statement("create table r (d decimal(10,2))")
    te.execute_statement("insert into r values (1.005), (-1.005), (2.004)")
    assert te.catalog.table("r")._data["d"].tolist() == [101, -101, 200]


# ---- C10: the query of a CTAS or an INSERT runs under the memory limit


def test_ctas_runs_under_the_memory_limit_c10():
    """At SF 0.001 with ``query_max_memory = 1024`` the port's CTAS raises
    ``ExceededMemoryLimitError`` and leaves no table; the JAX package runs
    the CTAS's query unbounded and stores 6,190 rows."""
    je, te = _engines(session={"query_max_memory": 1024})
    sql = ("create table x as select l_orderkey, l_quantity "
           "from lineitem")
    with pytest.raises(t_memory.ExceededMemoryLimitError):
        te.execute_statement(sql)
    assert "x" not in te.catalog
    assert je.execute_statement(sql).to_pylist() == [(6190,)]
    assert je.catalog.table("x").num_rows == 6190
    # the limit binds a plain query in both packages
    with pytest.raises(j_memory.ExceededMemoryLimitError):
        je.sql("select count(*) from lineitem")


def test_insert_select_runs_under_the_memory_limit_c10():
    """An INSERT ... SELECT above the limit is refused and leaves the
    table as it was; under a spill threshold instead of a limit the same
    INSERT spills its join and commits every row."""
    from presto1_tpu_torch.exec.stats import QueryStats

    _, te = _engines()
    te.execute_statement("create table s (k bigint, q decimal(12,2))")
    sql = ("insert into s select l_orderkey, l_quantity from lineitem, "
           "orders where l_orderkey = o_orderkey and o_orderkey < 2000")
    te.session.set("query_max_memory", 4096)
    with pytest.raises(t_memory.ExceededMemoryLimitError):
        te.execute_statement(sql)
    assert te.catalog.table("s").num_rows == 0
    te.session.set("query_max_memory", 0)
    te.session.set("spill_threshold", 4096)
    stats = QueryStats()
    n = te.execute_statement(sql, stats=stats).to_pylist()[0][0]
    assert n > 0 and te.catalog.table("s").num_rows == n
    assert any(op.spill for op in stats.operators.values())
    te.session.set("spill_threshold", 0)
    want = te.sql("select count(*) from lineitem, orders where "
                  "l_orderkey = o_orderkey and o_orderkey < 2000")
    assert want.to_pylist() == [(n,)]


# ---- system tables


def test_runtime_queries_reflect_history():
    for e in _engines():
        e.sql("select count(*) from nation")
        e.sql("select count(*) from region")
        out = e.sql("select state, count(*) c from system.runtime.queries "
                    "group by state order by state").to_pylist()
        assert dict(out) == {"FINISHED": 2, "RUNNING": 1}


def test_runtime_nodes_memory_uptime():
    je, te = _engines()
    sql = "select node_id, http_uri, state, success_rate from " \
          "system.runtime.nodes"
    assert te.sql(sql).to_pylist() == je.sql(sql).to_pylist()
    # the port's node names its device (a CPU engine: no card row)
    assert te.sql("select device from system.runtime.nodes"
                  ).to_pylist() == [("cpu",)]
    sql = "select pool, capacity_bytes, reserved_bytes from " \
          "system.runtime.memory"
    assert te.sql(sql).to_pylist() == je.sql(sql).to_pylist()
    assert te.sql("select uptime_s from system.runtime.uptime"
                  ).to_pylist()[0][0] >= 0.0


def test_failed_query_recorded():
    for e in _engines():
        with pytest.raises(Exception):
            e.sql("select no_such_column from nation")
        out = e.sql("select count(*) from system.runtime.queries "
                    "where state = 'FAILED'")
        assert out.to_pylist() == [(1,)]


def test_blackhole_swallow_and_synthesize():
    from presto1_tpu.exec.system_catalog import BlackholeTable as JBH
    from presto1_tpu.types import BIGINT as JB, VARCHAR as JV
    from presto1_tpu_torch.exec.system_catalog import BlackholeTable as TBH
    from presto1_tpu_torch.types import BIGINT as TB, VARCHAR as TV

    je, te = _engines()
    je.catalog.tables["sink"] = JBH("sink", [("x", JB)])
    te.catalog.tables["sink"] = TBH("sink", [("x", TB)], device="cpu")
    je.catalog.tables["synth"] = JBH("synth", [("k", JB), ("s", JV)],
                                     rows_per_scan=1000)
    te.catalog.tables["synth"] = TBH("synth", [("k", TB), ("s", TV)],
                                     rows_per_scan=1000, device="cpu")
    for sqls in (["insert into sink select n_nationkey from nation"],
                 ["select count(*) from sink"],
                 ["select count(*) c, sum(k) s from synth"]):
        want, got = _both((je, te), sqls)
        assert got.to_pylist() == want.to_pylist()
    assert got.to_pylist() == [(1000, 0)]


def test_runtime_metrics_table():
    _, te = _engines()
    te.sql("select count(*) from nation")
    out = te.sql("select name, kind, total from system.runtime.metrics "
                 "where name like 'engine.%' order by name").to_pandas()
    assert {"engine.queries_completed", "engine.query_wall_s"} <= \
        set(out.name)
    row = out[out.name == "engine.queries_completed"].iloc[0]
    assert row.kind == "counter" and row.total >= 1


# ---- the connector SPI


def _spi_table(mod_batch, mod_memory, mod_types, n=1000, **kw):
    t = mod_memory.MemoryTable("t", [("k", mod_types.BIGINT),
                                     ("v", mod_types.BIGINT)], **kw)
    t.append(mod_batch.from_numpy(
        {"k": np.arange(n, dtype=np.int64),
         "v": np.arange(n, dtype=np.int64) * 2},
        dict(k=mod_types.BIGINT, v=mod_types.BIGINT),
        **({"device": "cpu"} if kw else {})))
    return t


def _port_spi_table(n=1000):
    import presto1_tpu_torch.batch as B
    import presto1_tpu_torch.exec.memory_catalog as M
    import presto1_tpu_torch.types as T

    return _spi_table(B, M, T, n, device="cpu")


def test_fixed_count_split_manager():
    from presto1_tpu_torch.spi.connector import FixedCountSplitManager

    splits = FixedCountSplitManager().splits(_port_spi_table(), 4)
    assert [s.index for s in splits] == [0, 1, 2, 3]
    assert all(s.count == 4 and s.table == "t" for s in splits)
    assert splits[0].to_wire() == {"index": 0, "count": 4}


def test_page_source_streams_all_rows():
    from presto1_tpu_torch.exec.catalog import Catalog
    from presto1_tpu_torch.spi.connector import Connector

    t = _port_spi_table(1000)
    cat = Catalog()
    cat.tables["t"] = t
    conn = Connector(cat)
    total, seen = 0, []
    for split in conn.split_manager.splits(t, 3):
        for page in conn.page_source(split).pages(["k", "v"],
                                                  page_rows=128):
            n = int(page.num_rows)
            total += n
            seen.extend(page["k"].data[:n].tolist())
    assert total == 1000 and sorted(seen) == list(range(1000))


def test_page_sink_commits_atomically():
    from presto1_tpu_torch.batch import from_numpy
    from presto1_tpu_torch.types import BIGINT

    t = _port_spi_table(10)
    page = {"k": np.arange(5, dtype=np.int64), "v": np.zeros(5, np.int64)}
    sink = t.page_sink()
    sink.append(from_numpy(page, dict(k=BIGINT, v=BIGINT), device="cpu"))
    assert t.num_rows == 10  # invisible until finish
    assert sink.finish() == 5 and t.num_rows == 15
    sink2 = t.page_sink()
    sink2.append(from_numpy(page, dict(k=BIGINT, v=BIGINT), device="cpu"))
    sink2.abort()
    assert t.num_rows == 15  # aborted pages never land


def test_insert_select_failure_leaves_table_untouched():
    from presto1_tpu_torch.exec.catalog import Catalog

    cat = Catalog()
    cat.tables["t"] = _port_spi_table(10)
    engine = t_engine.Engine(cat, device="cpu")
    with pytest.raises(Exception):
        engine.execute_statement("insert into t select k, v from nonexistent")
    assert cat.table("t").num_rows == 10
    engine.execute_statement("insert into t values (100, 200)")
    assert cat.table("t").num_rows == 11
    assert engine.sql("select max(k), max(v) from t").to_pylist() == \
        [(100, 200)]


# ---- access control


def test_acl_unit():
    from presto1_tpu_torch.server.security import (
        AccessControl, AccessDeniedError, AccessRule)

    acl = AccessControl([AccessRule(user="u1", allow=True),
                         AccessRule(allow=False)])
    acl.check_can_select("u1", "tpch", "lineitem")
    with pytest.raises(AccessDeniedError):
        acl.check_can_select("u2", "tpch", "lineitem")
    assert acl.filter_tables("u2", "tpch", ["a", "b"]) == []


@pytest.mark.parametrize("compiled", [False, True])
def test_acl_covers_subquery_positions(compiled):
    """Tables reached only inside WHERE / SELECT subqueries and CTEs are
    checked on the plan's scans, fail-closed, eager and compiled."""
    from presto1_tpu_torch.server.security import (
        AccessControl, AccessDeniedError, AccessRule)

    acl = AccessControl([
        AccessRule(user="carol", table="nation|region", allow=True),
        AccessRule(allow=False)])
    eng = t_engine.Engine(t_catalog.TpchCatalog(sf=0.001, device="cpu"),
                          access_control=acl, device="cpu")
    eng.session.set("compile_queries", compiled)
    out = eng.sql("select count(*) c from nation", user="carol")
    assert out.to_pylist() == [(25,)]
    for sql in ("select n_name from nation where exists (select 1 from "
                "customer where c_nationkey = n_nationkey)",
                "select r_name from region where r_regionkey < "
                "(select count(*) from supplier)",
                "with x as (select * from customer) select count(*) from x"):
        with pytest.raises(AccessDeniedError):
            eng.sql(sql, user="carol")
    # a cached compiled statement is checked again for another user
    with pytest.raises(AccessDeniedError):
        eng.sql("select count(*) c from nation", user="mallory")


# ---- nested columns, Unnest and MarkDistinct through a spill


SPILLED = {
    "nested_through_grace_join":
        "select k, a, r_name from (select n_nationkey k, n_regionkey rk, "
        "array[n_nationkey, n_regionkey * 10] a from nation) t "
        "join region on rk = r_regionkey",
    "markdistinct_under_spilled_aggregate":
        "select l_returnflag, count(distinct l_partkey), "
        "count(distinct l_suppkey) from lineitem group by l_returnflag",
    "unnest_under_spilled_aggregate":
        "select e, count(*), sum(l_quantity) from lineitem cross join "
        "unnest(array[l_linenumber, l_linenumber + 1]) as u(e) group by e",
}


@pytest.mark.parametrize("name", sorted(SPILLED))
def test_spilled_statements_match_unspilled(name):
    """The same rows with and without a 256-byte spill threshold (nested
    payload columns spilled and brought back with their lengths)."""
    from presto1_tpu_torch.exec.executor import Executor

    _, te = _engines()
    sql = SPILLED[name]
    plan = te.plan(sql)
    ex = Executor(te.catalog, device="cpu", spill_threshold=256)
    got = ex.execute(plan)
    assert any(r.get("spilled") for r in ex.record.values())
    assert _rows(got) == _rows(te.sql(sql))


def test_spill_partitions_carry_nested_columns():
    """A nested column's element matrix, lengths and map values spill with
    its rows: membership and row order are the reference's for the flat
    columns (its ``spill_partitions`` cannot take a nested column), the
    nested parts those of the same rows."""
    import jax.numpy as jnp

    import presto1_tpu.exec.spill as j_spill
    from presto1_tpu.batch import Column as JC, RecordBatch as JRB
    from presto1_tpu.types import BIGINT as JB
    from presto1_tpu_torch.batch import Column as TC, RecordBatch as TRB
    from presto1_tpu_torch.exec import spill as t_spill
    from presto1_tpu_torch.types import ArrayType as TA, BIGINT as TB, \
        MapType as TM

    rng = np.random.default_rng(11)
    n, live = 600, 555
    k = rng.integers(0, 50, n).astype(np.int64)
    a = rng.integers(-9, 9, (n, 4)).astype(np.int64)
    lens = rng.integers(0, 5, n).astype(np.int32)
    mv = rng.integers(0, 99, (n, 4)).astype(np.int64)
    rid = np.arange(n, dtype=np.int64)
    jb = JRB({"k": JC(jnp.asarray(k), JB), "rid": JC(jnp.asarray(rid), JB)},
             live)
    tb = TRB({"k": TC(torch.from_numpy(k), TB),
              "rid": TC(torch.from_numpy(rid), TB),
              "a": TC(torch.from_numpy(a), TA(TB),
                      lengths=torch.from_numpy(lens)),
              "m": TC(torch.from_numpy(a), TM(TB, TB),
                      lengths=torch.from_numpy(lens),
                      map_values=torch.from_numpy(mv))}, live)
    ranges = [(0, 49)]
    want = j_spill.spill_partitions(jb, ["k"], ranges, 8)
    got = t_spill.spill_partitions(tb, ["k"], ranges, 8)
    assert [p.num_rows for p in got] == [p.num_rows for p in want]
    for g, w in zip(got, want):
        rows = g.columns["rid"][0].numpy()
        np.testing.assert_array_equal(rows, np.asarray(w.columns["rid"][0]))
        np.testing.assert_array_equal(g.columns["a"][0].numpy(), a[rows])
        np.testing.assert_array_equal(g.nested["a"][0].numpy(), lens[rows])
        np.testing.assert_array_equal(g.nested["m"][1].numpy(), mv[rows])
    whole = t_spill.unspill(t_spill.concat_spilled(got), device="cpu")
    order = whole["rid"].data[:live].numpy()
    np.testing.assert_array_equal(np.sort(order), np.arange(live))
    np.testing.assert_array_equal(whole["a"].lengths[:live].numpy(),
                                  lens[order])
    np.testing.assert_array_equal(whole["m"].map_values[:live].numpy(),
                                  mv[order])


# ---- devices


def test_literal_lands_on_the_batch_device():
    """``_literal_value`` takes the device it must place the literal on
    (no default), and a literal evaluated against a batch lands on the
    batch's device."""
    import inspect

    from presto1_tpu_torch.batch import Column, RecordBatch
    from presto1_tpu_torch.expr import eval as t_eval, ir as t_ir
    from presto1_tpu_torch.types import BIGINT

    param = inspect.signature(t_eval._literal_value).parameters["device"]
    assert param.default is inspect.Parameter.empty
    lit = t_ir.Literal(7, BIGINT)
    with pytest.raises(TypeError):
        t_eval._literal_value(lit)
    for dev in ("cpu", "meta"):
        b = RecordBatch({"a": Column(torch.zeros(4, dtype=torch.int64,
                                                 device=dev), BIGINT)}, 4)
        out = t_eval.eval_expr(
            t_ir.call("+", t_ir.col("a", BIGINT), lit, type=BIGINT), b)
        assert out.data.device.type == dev
        assert t_eval.eval_expr(lit, b).data.device.type == dev


def test_tables_live_on_the_engine_device():
    """Tables an engine creates take its device; none defaults to the
    CPU."""
    from presto1_tpu_torch.exec.memory_catalog import MemoryTable
    from presto1_tpu_torch.exec.system_catalog import (BlackholeTable,
                                                        DynamicTable)
    from presto1_tpu_torch.types import BIGINT

    for cls, extra in ((MemoryTable, ()), (BlackholeTable, ()),
                       (DynamicTable, (lambda: {},))):
        assert cls("t", [("x", BIGINT)], *extra).device.type == "cuda"
    _, te = _engines()
    te.execute_statement("create table d (x bigint)")
    assert te.catalog.table("d").device.type == "cpu"
    assert te.catalog.table("system.runtime.queries").device.type == "cpu"


def test_import_with_jax_blocked():
    """The modules of this slice import and run with jax and the JAX
    package unimportable."""
    code = (
        "import sys, importlib.abc\n"
        "class Block(importlib.abc.MetaPathFinder):\n"
        "    def find_spec(self, name, path, target=None):\n"
        "        top = name.split('.')[0]\n"
        "        if top in ('jax', 'jaxlib', 'presto1_tpu'):\n"
        "            raise ImportError('blocked: ' + name)\n"
        "sys.meta_path.insert(0, Block())\n"
        "import torch\n"
        "torch.set_num_threads(1)\n"
        "import presto1_tpu_torch.exec.pages as P\n"
        "import presto1_tpu_torch.exec.memory_catalog\n"
        "import presto1_tpu_torch.exec.system_catalog\n"
        "import presto1_tpu_torch.spi.connector\n"
        "import presto1_tpu_torch.server.security\n"
        "from presto1_tpu_torch.exec.catalog import TpchCatalog\n"
        "from presto1_tpu_torch.exec.engine import Engine\n"
        "e = Engine(TpchCatalog(sf=0.001, device='cpu'), device='cpu')\n"
        "e.execute_statement('create table t as select n_nationkey k "
        "from nation')\n"
        "assert e.sql('select count(distinct k), count(distinct "
        "n_regionkey) from t, nation where k = n_nationkey'"
        ").to_pylist() == [(25, 5)]\n"
        "assert e.sql('select sum(u) from t cross join unnest(array[k, k]) "
        "as x(u)').to_pylist() == [(600,)]\n"
        "assert e.compile('select approx_distinct(k) from t')()"
        ".to_pylist() == [(25,)]\n"
        "b = e.sql('select k from t order by k limit 3')\n"
        "assert P.deserialize_batch(P.serialize_batch(b)).to_pylist() == "
        "[(0,), (1,), (2,)]\n"
        "print('clean')\n")
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    out = subprocess.run([sys.executable, "-c", code], cwd=root,
                         capture_output=True, text=True, timeout=600)
    assert out.returncode == 0, out.stderr[-2000:]
    assert out.stdout.strip().endswith("clean")
