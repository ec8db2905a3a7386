"""The slice as a whole: TPC-H Q6 (and a few more scan / filter / project /
global-aggregate statements) through the port's engine on the CPU, against
the JAX package's engine and the pandas oracle, at SF 0.01.

Integers, decimals, dates and validity exact; doubles to 1e-6 relative.
"""

import subprocess
import sys

import numpy as np
import pytest
import torch

import presto1_tpu.exec.catalog as j_catalog
import presto1_tpu.exec.engine as j_engine
import presto1_tpu_torch.exec.catalog as t_catalog
import presto1_tpu_torch.exec.engine as t_engine
import presto1_tpu_torch.exec.executor as t_executor
from presto1_tpu.tpch.queries import QUERIES as J_QUERIES
from presto1_tpu_torch.exec.session import Session
from presto1_tpu_torch.ops.kernels import filter_sum as F
from presto1_tpu_torch.testing.verifier import compare_frames
from presto1_tpu_torch.tpch.queries import QUERIES

from torch_parity import assert_batches_equal
from tpch_oracle import ORACLE

# the tests are tiny; one thread keeps torch's pool from competing with the
# other test workers' 8-device CPU meshes for the same cores
torch.set_num_threads(1)

Q6_COLUMNS = ("l_shipdate", "l_discount", "l_quantity", "l_extendedprice")


@pytest.fixture(scope="module")
def engines():
    jc = j_catalog.TpchCatalog("tiny")
    tc = t_catalog.TpchCatalog("tiny", device="cpu")
    return j_engine.Engine(jc), t_engine.Engine(tc, device="cpu")


def test_queries_text_is_the_same():
    assert QUERIES == J_QUERIES


@pytest.mark.parametrize("column", Q6_COLUMNS + ("l_shipmode", "l_orderkey"))
def test_dbgen_columns_equal_reference(engines, column):
    je, te = engines
    jc = je.catalog.table("lineitem").column(column)
    tc = te.catalog.table("lineitem").column(column)
    assert str(jc.type) == str(tc.type)
    assert tc.data.device.type == "cpu" and tc.validity is None
    jd = np.asarray(jc.data)
    assert jd.dtype == tc.data.numpy().dtype
    np.testing.assert_array_equal(jd, tc.data.numpy())
    if jc.dictionary is not None:
        np.testing.assert_array_equal(jc.dictionary, tc.dictionary)
    assert je.catalog.table("lineitem").num_rows == \
        te.catalog.table("lineitem").num_rows
    if column != "l_shipmode":
        assert je.catalog.table("lineitem").column_range(column) == \
            te.catalog.table("lineitem").column_range(column)


def test_columns_are_placed_once_and_cached(engines):
    _, te = engines
    li = te.catalog.table("lineitem")
    a = li.column("l_quantity")
    assert li.column("l_quantity") is a
    assert li.column("l_quantity", "cpu") is a
    assert li.batch(["l_quantity"])["l_quantity"] is a
    host = li.host_column("l_quantity")
    np.testing.assert_array_equal(np.asarray(host.data), a.data.numpy())


@pytest.mark.parametrize("index", [0, 1, 2])
def test_sharded_catalog_matches_reference(engines, index):
    """Row-range shards: same slices as the reference, and Q6 over the
    shards adds up to Q6 over the whole table."""
    je, te = engines
    js = j_catalog.ShardedCatalog(je.catalog, index, 3)
    ts = t_catalog.ShardedCatalog(te.catalog, index, 3)
    jt, tt = js.table("lineitem"), ts.table("lineitem")
    assert (jt.lo, jt.hi, jt.num_rows) == (tt.lo, tt.hi, tt.num_rows)
    for column in ("l_quantity", "l_shipmode"):
        jc, tc = jt.column(column), tt.column(column)
        np.testing.assert_array_equal(np.asarray(jc.data), tc.data.numpy())
        np.testing.assert_array_equal(np.asarray(tt.host_column(column).data),
                                      tc.data.numpy())
    want = j_engine.Engine(js).sql(QUERIES[6])
    got = t_engine.Engine(ts, device="cpu").sql(QUERIES[6])
    assert_batches_equal(want, got, f"shard {index}")
    if index == 2:
        parts = [int(t_engine.Engine(t_catalog.ShardedCatalog(te.catalog, i, 3),
                                     device="cpu")
                     .sql(QUERIES[6])["revenue"].data[0]) for i in range(3)]
        assert sum(parts) == 12632580823


def test_explain_equals_reference(engines):
    je, te = engines
    assert te.explain(QUERIES[6]) == je.explain(QUERIES[6])


def _q6_oracle(te):
    frames = {"lineitem": te.catalog.table("lineitem").batch(
        list(Q6_COLUMNS)).to_pandas()}
    return ORACLE[6](frames)


@pytest.mark.parametrize("mode", ["sql", "compiled_call", "block_run",
                                  "session_compile_queries"])
def test_q6_matches_reference_and_oracle(engines, mode):
    je, te = engines
    want = je.sql(QUERIES[6])
    before = F.LAUNCHES
    if mode == "sql":
        got = te.sql(QUERIES[6])
    elif mode == "compiled_call":
        got = te.compile(QUERIES[6])()
    elif mode == "block_run":
        cq = te.compile(QUERIES[6], sample=None)
        assert cq.block_run(reps=3) == 1
        assert cq.scan_tables == ["lineitem"]
        assert all(t.device.type == "cpu" for t in cq.inputs.values())
        cq.precompile()
        got = cq()
    else:
        sess = Session()
        sess.set("compile_queries", True)
        eng = t_engine.Engine(te.catalog, session=sess, device="cpu")
        eng.sql(QUERIES[6])
        got = eng.sql(QUERIES[6])
        assert list(eng._compiled_cache) == [QUERIES[6]]
    assert F.LAUNCHES == before  # CPU tensors never launch the kernel
    assert_batches_equal(want, got, mode)
    assert got.to_pylist() == [(1263258.0823,)]
    assert int(got["revenue"].data[0]) == 12632580823
    assert str(got["revenue"].type) == "decimal(38,4)"
    assert compare_frames(got.to_pandas(), _q6_oracle(te)) is None


STATEMENTS = {
    "count_star": "select count(*) from lineitem",
    "minmaxavg": "select min(l_quantity), max(l_extendedprice), "
                 "avg(l_discount), avg(l_extendedprice), sum(l_tax), "
                 "count(l_orderkey) from lineitem",
    "string_predicate": "select count(*), sum(l_quantity) from lineitem "
                        "where l_shipmode = 'AIR'",
    "string_in_like": "select count(*) from lineitem where l_shipmode in "
                      "('MAIL', 'SHIP') and l_shipinstruct like 'DELIVER%'",
    "filter_project_limit": "select l_orderkey, l_extendedprice * "
                            "(1 - l_discount) as net, l_shipdate from "
                            "lineitem where l_quantity < 3 limit 7",
    "limit_offset": "select l_orderkey, l_linenumber from lineitem "
                    "offset 5 limit 4",
    "project_case": "select l_orderkey, case when l_discount > 0.05 then "
                    "l_extendedprice else 0 end as x from lineitem "
                    "where l_shipdate < date '1992-03-01'",
    "empty_result_sum": "select sum(l_extendedprice * l_discount) from "
                        "lineitem where l_shipdate < date '1900-01-01' and "
                        "l_discount between 0.01 and 0.02 and "
                        "l_quantity < 5",
    "double_arith": "select sum(cast(l_quantity as double) * 0.5), "
                    "avg(cast(l_extendedprice as double)) from lineitem "
                    "where l_returnflag = 'R'",
    "single_row": "select 1 + 2, 3 * 4",
    "other_tables": "select count(*), max(o_totalprice), min(o_orderdate) "
                    "from orders where o_orderpriority = '1-URGENT'",
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


def _agg_and_below(te, sql):
    plan = te.plan(sql)
    agg = plan.child
    ex = t_executor.Executor(te.catalog, device="cpu")
    below = ex.execute(agg.child.child, (0, 0, 0))
    return agg, below


def test_matcher_accepts_q6(engines):
    _, te = engines
    agg, below = _agg_and_below(te, QUERIES[6])
    m = t_executor.match_range_product_sum(agg, below)
    assert m is not None
    assert [c.split("#")[0] for c in m.columns] == list(Q6_COLUMNS)
    assert m.bounds == (8766, 9131, 5, 7, 2400)


MATCHES = {
    # other comparison forms normalise to the same half-open bounds
    "gt_le_flipped": (
        "select sum(l_discount * l_extendedprice) from lineitem where "
        "l_shipdate > date '1993-12-31' and date '1995-01-01' > l_shipdate "
        "and l_discount >= 0.05 and 0.07 >= l_discount "
        "and l_quantity <= 23.99", (8766, 9131, 5, 7, 2400)),
    "equality_is_a_range": (
        "select sum(l_extendedprice * l_discount) from lineitem where "
        "l_shipdate >= date '1994-01-01' and l_shipdate < date '1995-01-01' "
        "and l_discount = 0.06 and l_quantity < 24",
        (8766, 9131, 6, 6, 2400)),
    "tightest_bounds_win": (
        "select sum(l_extendedprice * l_discount) from lineitem where "
        "l_shipdate >= date '1994-01-01' and l_shipdate >= date '1994-02-01' "
        "and l_shipdate < date '1995-01-01' and l_discount between 0.05 "
        "and 0.07 and l_quantity < 24 and l_quantity < 30",
        (8797, 9131, 5, 7, 2400)),
}


@pytest.mark.parametrize("name", sorted(MATCHES))
def test_matcher_normalises(engines, name):
    je, te = engines
    sql, bounds = MATCHES[name]
    agg, below = _agg_and_below(te, sql)
    m = t_executor.match_range_product_sum(agg, below)
    assert m is not None and m.bounds == bounds
    assert_batches_equal(je.sql(sql), te.sql(sql), name)


NEAR_MISSES = {
    "sum_of_sum": "select sum(l_extendedprice + l_discount) from lineitem "
                  "where l_shipdate >= date '1994-01-01' and l_shipdate < "
                  "date '1995-01-01' and l_discount between 0.05 and 0.07 "
                  "and l_quantity < 24",
    "an_or": "select sum(l_extendedprice * l_discount) from lineitem where "
             "(l_shipdate >= date '1994-01-01' or l_shipdate < date "
             "'1993-01-01') and l_discount between 0.05 and 0.07 "
             "and l_quantity < 24",
    "two_aggregates": "select sum(l_extendedprice * l_discount), count(*) "
                      "from lineitem where l_shipdate >= date '1994-01-01' "
                      "and l_shipdate < date '1995-01-01' and l_discount "
                      "between 0.05 and 0.07 and l_quantity < 24",
    "missing_lower_bound": "select sum(l_extendedprice * l_discount) from "
                           "lineitem where l_shipdate < date '1995-01-01' "
                           "and l_discount between 0.05 and 0.07 "
                           "and l_quantity < 24",
    "bound_not_on_a_factor": "select sum(l_extendedprice * l_tax) from "
                             "lineitem where l_shipdate >= date "
                             "'1994-01-01' and l_shipdate < date "
                             "'1995-01-01' and l_discount between 0.05 "
                             "and 0.07 and l_quantity < 24",
    "double_constant": "select sum(l_extendedprice * l_discount) from "
                       "lineitem where l_shipdate >= date '1994-01-01' and "
                       "l_shipdate < date '1995-01-01' and l_discount "
                       "between 0.05 and 0.07 and l_quantity < 24e0",
    "finer_scale_constant": "select sum(l_extendedprice * l_discount) from "
                            "lineitem where l_shipdate >= date '1994-01-01' "
                            "and l_shipdate < date '1995-01-01' and "
                            "l_discount between 0.05 and 0.07 "
                            "and l_quantity < 24.005",
    "string_conjunct": "select sum(l_extendedprice * l_discount) from "
                       "lineitem where l_shipdate >= date '1994-01-01' and "
                       "l_shipdate < date '1995-01-01' and l_discount "
                       "between 0.05 and 0.07 and l_quantity < 24 "
                       "and l_shipmode = 'AIR'",
}


@pytest.mark.parametrize("name", sorted(NEAR_MISSES))
def test_matcher_rejects_near_miss(engines, name):
    je, te = engines
    sql = NEAR_MISSES[name]
    agg, below = _agg_and_below(te, sql)
    assert t_executor.match_range_product_sum(agg, below) is None
    assert_batches_equal(je.sql(sql), te.sql(sql), name)


def test_matcher_rejects_nullable_and_dictionary_columns(engines):
    _, te = engines
    agg, below = _agg_and_below(te, QUERIES[6])
    assert t_executor.match_range_product_sum(agg, below) is not None
    sym = next(s for s in below.columns if s.startswith("l_quantity"))
    n = below.capacity()
    for change in ({"validity": torch.ones(n, dtype=torch.bool)},
                   {"dictionary": np.array(["x"])},
                   {"data": below[sym].data.double()}):
        cols = dict(below.columns)
        cols[sym] = type(below[sym])(**{
            "data": below[sym].data, "type": below[sym].type, **change})
        other = type(below)(cols, below.num_rows)
        assert t_executor.match_range_product_sum(agg, other) is None
    unknown_rows = type(below)(below.columns, torch.tensor(below.num_rows))
    assert t_executor.match_range_product_sum(agg, unknown_rows) is None


@pytest.mark.parametrize("compiled", [False, True])
def test_routed_and_generic_paths_agree(engines, compiled):
    _, te = engines
    plan = te.plan(QUERIES[6])
    outs = []
    for route in (True, False):
        if compiled:
            cq = t_executor.CompiledQuery(te.catalog, plan, device="cpu",
                                          route_kernels=route)
            assert (cq.record.get((0,), {}).get("range_sum")
                    is not None) == route
            out = cq()
        else:
            ex = t_executor.Executor(te.catalog, device="cpu",
                                     route_kernels=route)
            out = ex.execute(plan)
            assert len(ex.overflow_checks) == 1
            assert bool(ex.overflow_checks[0])
        outs.append(out)
    a, b = outs
    assert list(a.columns) == list(b.columns) == ["revenue"]
    ca, cb = a["revenue"], b["revenue"]
    assert ca.type == cb.type and ca.data.dtype == cb.data.dtype
    assert torch.equal(ca.data, cb.data)
    assert torch.equal(ca.validity, cb.validity)


def test_routing_goes_through_the_kernel_wrapper(engines, monkeypatch):
    """The Q6 fragment reaches ``range_filter_limb_sums`` once per run, with
    the catalog's own tensors (no copy, no cast) and the matched bounds."""
    _, te = engines
    calls = []
    real = t_executor.range_filter_limb_sums

    def spy(ship, disc, qty, price, bounds):
        calls.append((ship, disc, qty, price, bounds))
        return real(ship, disc, qty, price, bounds)

    monkeypatch.setattr(t_executor, "range_filter_limb_sums", spy)
    te.sql(QUERIES[6])
    cq = te.compile(QUERIES[6])
    cq.block_run(reps=2)
    assert len(calls) == 4
    li = te.catalog.table("lineitem")
    for ship, disc, qty, price, bounds in calls:
        assert [t.dtype for t in (ship, disc, qty, price)] == \
            [torch.int32, torch.int64, torch.int64, torch.int64]
        for t, c in zip((ship, disc, qty, price), Q6_COLUMNS):
            assert t.data_ptr() == li.column(c).data.data_ptr()
        assert bounds.tolist() == [8766, 9131, 5, 7, 2400]


@pytest.mark.parametrize("sql,item", [
    ("select count(distinct l_partkey), count(distinct l_suppkey) "
     "from lineitem", "A9.4"),
    ("select n_name, x from nation cross join unnest(array[1, 2]) as t(x)",
     "A9.4"),
    ("select cardinality(array[n_nationkey, 2]) from nation", "A9.3"),
    ("select approx_distinct(l_partkey) from lineitem", "A9.3"),
], ids=["mark_distinct", "unnest", "arrays", "hll"])
def test_later_plan_nodes_raise(engines, sql, item):
    """What raised until its slice (ROADMAP ``item``: MarkDistinct, Unnest,
    arrays and the HLL device hashes) now answers as the reference does."""
    je, te = engines
    assert sorted(te.sql(sql).to_pylist()) == sorted(je.sql(sql).to_pylist())


def test_join_and_grouped_aggregate_raise(engines):
    """Joins and grouped aggregates run, and so do their spilled forms
    (``_grace_join``, ``_spilled_aggregate``: the same rows, partitioned
    through host RAM); external fragment inputs, which raised naming ROADMAP
    A12 until the server plane's slice, now run: a compiled Q6 whose
    aggregate input arrives as a stub equals the eager executor's."""
    _, te = engines
    join = ("select count(*) from lineitem, orders "
            "where l_orderkey = o_orderkey")
    group = "select l_returnflag, count(*) from lineitem group by l_returnflag"
    got = te.sql(join)
    assert got.to_pylist() == [(te.catalog.table("lineitem").num_rows,)]
    got = te.sql(group)
    assert [r[0] for r in got.to_pylist()] == ["A", "N", "R"]
    for sql, node in ((join, "Join"), (group, "Aggregate")):
        ex = t_executor.Executor(te.catalog, device="cpu",
                                 spill_threshold=4096)
        plan = te.plan(sql)
        # no ORDER BY: partitions come back in their own order
        assert sorted(ex.execute(plan).to_pylist()) == \
            sorted(te.sql(sql).to_pylist())
        spilled = [p for p, r in ex.record.items() if r.get("spilled")]
        assert spilled and all(
            type(t_executor._node_at(plan, p)).__name__ == node
            for p in spilled)
    plan = te.plan(QUERIES[6])
    below = t_executor._node_at(plan, (0, 0))
    stub = t_executor.Executor(te.catalog, device="cpu").execute(below)
    stubs = {(0, 0): stub}
    cq = t_executor.CompiledQuery(te.catalog, plan, stubs=stubs,
                                  device="cpu")
    assert cq(stubs=stubs).to_pylist() == t_executor.Executor(
        te.catalog, device="cpu", stubs=stubs).execute(plan).to_pylist() \
        == te.sql(QUERIES[6]).to_pylist()


def test_overflow_guard_raises_after_the_one_readback(engines):
    """A compiled plan whose data outgrew discovery raises ExecError."""
    _, te = engines
    cq = te.compile("select l_orderkey from lineitem where l_quantity < 2")
    assert cq.block_run(reps=2) == cq().num_rows
    rec = cq.record[(0, 0)]
    rec["capacity"] = 128  # as if discovery had seen far fewer rows
    cq._caps[()] = 128
    with pytest.raises(t_executor.ExecError, match="overflow"):
        cq()
    with pytest.raises(t_executor.ExecError, match="overflow"):
        cq.block_run(reps=2)


def test_default_device_is_cuda_and_nothing_falls_back(engines):
    """Without a CUDA device the default ``device="cuda"`` raises."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    _, te = engines
    with pytest.raises((AssertionError, RuntimeError)):
        t_catalog.TpchCatalog("tiny").table("nation").column("n_nationkey")
    with pytest.raises((AssertionError, RuntimeError)):
        t_engine.Engine(te.catalog).sql("select count(*) from nation")


def test_import_leaves_jax_and_reference_out():
    code = (
        "import sys\n"
        "import presto1_tpu_torch\n"
        "import presto1_tpu_torch.exec.engine, presto1_tpu_torch.exec.catalog\n"
        "import presto1_tpu_torch.ops.kernels.filter_sum\n"
        "import presto1_tpu_torch.testing.parity\n"
        "import presto1_tpu_torch.testing.verifier\n"
        "from presto1_tpu_torch.exec.catalog import TpchCatalog\n"
        "from presto1_tpu_torch.exec.engine import Engine\n"
        "from presto1_tpu_torch.tpch.queries import QUERIES\n"
        "e = Engine(TpchCatalog('tiny', device='cpu'), device='cpu')\n"
        "assert e.sql(QUERIES[6]).to_pylist() == [(1263258.0823,)]\n"
        "bad = sorted(m for m in sys.modules if m == 'jax' or "
        "m.startswith('jax.') or m == 'jaxlib' or m == 'presto1_tpu' "
        "or m.startswith('presto1_tpu.'))\n"
        "assert not bad, bad\n"
        "assert 'triton' not in sys.modules\n"
        "print('clean')\n")
    import os

    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    out = subprocess.run([sys.executable, "-c", code], cwd=root,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-2000:]
    assert out.stdout.strip().endswith("clean")


def test_sources_name_neither_jax_nor_the_reference_package():
    """No import of jax or of the reference package anywhere in the port
    or in the smoke script (prose may name them)."""
    import os
    import re

    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    pat = re.compile(r"^\s*(import|from)\s+(jax|jaxlib|presto1_tpu)(\.|\s|$)",
                     re.M)
    files = [os.path.join(root, "chip_smoke.py")]
    for d, _, names in os.walk(os.path.join(root, "presto1_tpu_torch")):
        files += [os.path.join(d, n) for n in names if n.endswith(".py")]
    assert len(files) > 30
    bad = [f for f in files if pat.search(open(f).read())]
    assert not bad, bad
