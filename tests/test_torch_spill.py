"""Spilling in the port (``exec/spill.py``, ``Executor._grace_join`` and
``_spilled_aggregate``) against the JAX package's, at SF 0.001 with a
4,096-byte spill threshold, so that every join kind and every grouped
aggregation of ``tests/test_spill.py`` runs partitioned through host RAM.

For each statement: the port's spilled answer equals the JAX package's
spilled answer and the port's unspilled one; the same plan nodes spill in
both packages, into the same number of partitions.  Below the engine,
``partition_ids`` and the membership and row order of each spilled
partition equal the JAX package's on the same batch.  Integers, decimals,
dates, strings and validity exact; doubles to 1e-6 relative.
"""

import numpy as np
import pytest
import torch

import presto1_tpu.exec.catalog as j_catalog
import presto1_tpu.exec.engine as j_engine
import presto1_tpu.exec.executor as j_executor
import presto1_tpu.exec.spill as j_spill
import presto1_tpu.ops.common as j_common
import presto1_tpu_torch.exec.catalog as t_catalog
import presto1_tpu_torch.exec.engine as t_engine
import presto1_tpu_torch.exec.executor as t_executor
import presto1_tpu_torch.exec.session as t_session
import presto1_tpu_torch.exec.spill as t_spill
import presto1_tpu_torch.ops.common as t_common

from test_tpch import assert_frames_match
from torch_parity import both_batches

torch.set_num_threads(1)

THRESHOLD = 4096
STATEMENTS = {
    "inner": "select o_orderkey, o_totalprice, c_name from orders "
             "join customer on o_custkey = c_custkey order by o_orderkey",
    "left_with_nulls": "select c_custkey, c_name, o_orderkey from customer "
                       "left join orders on c_custkey = o_custkey "
                       "order by c_custkey, o_orderkey",
    "semi": "select c_custkey from customer where c_custkey in "
            "(select o_custkey from orders) order by c_custkey",
    "anti": "select c_custkey from customer where c_custkey not in "
            "(select o_custkey from orders) order by c_custkey",
    "full_outer": "select c_custkey, o_orderkey from customer "
                  "full outer join orders on c_custkey = o_custkey "
                  "order by c_custkey, o_orderkey",
    "residual": "select o_orderkey, l_linenumber from orders join lineitem "
                "on o_orderkey = l_orderkey and l_quantity > 25 "
                "order by o_orderkey, l_linenumber",
    "aggregation": "select l_orderkey, count(*) c, sum(l_extendedprice) s, "
                   "min(l_discount) mn, max(l_tax) mx from lineitem "
                   "group by l_orderkey order by l_orderkey",
    "multi_key_avg": "select l_returnflag, l_linestatus, avg(l_quantity) a, "
                     "count(*) c from lineitem "
                     "group by l_returnflag, l_linestatus "
                     "order by l_returnflag, l_linestatus",
    "q3_shape": "select l_orderkey, sum(l_extendedprice * (1 - l_discount)) "
                "rev from customer, orders, lineitem "
                "where c_mktsegment = 'BUILDING' and c_custkey = o_custkey "
                "and l_orderkey = o_orderkey "
                "and o_orderdate < date '1995-03-15' "
                "group by l_orderkey order by rev desc limit 10",
    "partition_count": "select o_custkey, count(*) c from orders "
                       "group by o_custkey",
}


@pytest.fixture(scope="module")
def engines():
    return (j_engine.Engine(j_catalog.TpchCatalog(sf=0.001)),
            t_engine.Engine(t_catalog.TpchCatalog(sf=0.001, device="cpu"),
                            device="cpu"))


def _spilled(record):
    return {p: r["spill_partitions"] for p, r in record.items()
            if r.get("spilled")}


@pytest.mark.parametrize("name", sorted(STATEMENTS))
def test_spilled_statement_matches_the_reference(engines, name):
    je, te = engines
    sql = STATEMENTS[name]
    jx = j_executor.Executor(je.catalog, spill_threshold=THRESHOLD)
    want = jx.execute(je.plan(sql)).to_pandas()
    tx = t_executor.Executor(te.catalog, spill_threshold=THRESHOLD,
                             device="cpu")
    got = tx.execute(te.plan(sql)).to_pandas()
    assert_frames_match(got, want, ordered="order by" in sql)
    assert_frames_match(got, te.sql(sql).to_pandas(),
                        ordered="order by" in sql)
    spilled = _spilled(tx.record)
    assert spilled, f"{name}: nothing spilled"
    assert spilled == _spilled(jx.record)
    assert all(n >= 2 for n in spilled.values())
    # every spilled node says what it moved over PCIe
    for p in spilled:
        moved = tx.record[p]["spill"]
        assert moved["partitions"] == spilled[p]
        assert moved["to_host_bytes"] > 0 and moved["from_host_bytes"] > 0


def test_session_threshold_spills_through_engine_sql(engines):
    """The session's ``spill_threshold`` reaches the executor (C5's
    other half: the port's ``Engine.sql`` read none of it), and
    ``spill_enabled = false`` turns it off."""
    from presto1_tpu_torch.exec.stats import QueryStats

    _, te = engines
    sql = STATEMENTS["q3_shape"]
    for enabled in (True, False):
        s = t_session.Session()
        s.set("spill_threshold", THRESHOLD)
        s.set("spill_enabled", enabled)
        e = t_engine.Engine(te.catalog, session=s, device="cpu")
        stats = QueryStats()
        got = e.sql(sql, stats=stats).to_pandas()
        assert_frames_match(got, te.sql(sql).to_pandas(), ordered=True)
        spilled = {p: op.spill for p, op in stats.operators.items()
                   if op.spill}
        assert bool(spilled) == enabled
        for p, moved in spilled.items():
            assert "spilled:" in stats.operators[p].detail
            assert moved["partitions"] >= 2


def _batch(rows, seed):
    rng = np.random.default_rng(seed)
    return both_batches({
        "k1": (rng.integers(-40, 300, rows), rng.random(rows) < 0.9,
               "bigint"),
        "k2": (rng.integers(0, 7, rows).astype(np.int32), None, "integer"),
        "v": (rng.random(rows), rng.random(rows) < 0.7, "double"),
        "d": (rng.integers(-10**5, 10**5, rows), None, "decimal(10,2)"),
        "s": (rng.integers(0, 4, rows).astype(np.int32), None, "varchar",
              np.array(["ab", "cd", "ef", "gh"])),
    }, num_rows=rows - rows // 7)


KEYS = {"one": ["k1"], "two": ["k1", "k2"], "string": ["s", "k2"]}


@pytest.mark.parametrize("parts", [2, 16, 256])
@pytest.mark.parametrize("keys", sorted(KEYS))
def test_partition_ids_equal_the_reference(keys, parts):
    jb, tb = _batch(2048, parts)
    names = KEYS[keys]
    ranges = t_common.key_ranges([tb[k] for k in names], tb.num_rows)
    assert ranges == j_common.key_ranges([jb[k] for k in names],
                                         jb.num_rows)
    want = np.asarray(j_spill.partition_ids([jb[k] for k in names], ranges,
                                            jb.num_rows, parts))
    got = t_spill.partition_ids([tb[k] for k in names], ranges, tb.num_rows,
                                parts).numpy()
    live = tb.num_rows
    np.testing.assert_array_equal(got[:live], want[:live])
    assert got[:live].min() >= 0 and got[:live].max() < parts


@pytest.mark.parametrize("parts", [2, 16])
@pytest.mark.parametrize("keys", sorted(KEYS))
def test_spill_partitions_rows_and_order_equal_the_reference(keys, parts):
    jb, tb = _batch(1500, 7 * parts)
    names = KEYS[keys]
    ranges = t_common.key_ranges([tb[k] for k in names], tb.num_rows)
    want = j_spill.spill_partitions(jb, names, ranges, parts)
    got = t_spill.spill_partitions(tb, names, ranges, parts)
    assert [p.num_rows for p in got] == [p.num_rows for p in want]
    assert sum(p.num_rows for p in got) == tb.num_rows
    for g, w in zip(got, want):
        assert list(g.columns) == list(w.columns)
        for name, (data, valid, dic, t) in g.columns.items():
            wdata, wvalid, wdic, wt = w.columns[name]
            assert str(t) == str(wt)
            np.testing.assert_array_equal(data.numpy(), np.asarray(wdata))
            assert (valid is None) == (wvalid is None)
            if valid is not None:
                np.testing.assert_array_equal(valid.numpy(),
                                              np.asarray(wvalid))
            assert (dic is None) == (wdic is None)


def test_spill_unspill_concat_round_trip():
    """Host copies come back padded to the requested capacity, zeros past
    the live rows; concatenated partitions keep every row once."""
    _, tb = _batch(700, 3)
    parts = t_spill.spill_partitions(tb, ["k1"], t_common.key_ranges(
        [tb["k1"]], tb.num_rows), 4)
    merged = t_spill.concat_spilled(parts)
    assert merged.num_rows == tb.num_rows
    assert merged.nbytes() == sum(p.nbytes() for p in parts)
    back = t_spill.unspill(merged, capacity=1024, device="cpu")
    assert back.capacity() == 1024 and back.num_rows == tb.num_rows
    n = tb.num_rows
    for name in tb.names:
        assert not back[name].data[n:].any()
        want = np.sort(tb[name].data[:n].numpy())
        np.testing.assert_array_equal(np.sort(back[name].data[:n].numpy()),
                                      want)
    one = t_spill.spill(tb)
    again = t_spill.unspill(one, device="cpu")
    for name in tb.names:
        assert torch.equal(again[name].data[:n], tb[name].data[:n])
    assert not one.pinned  # page-locked memory only for a CUDA source


@pytest.mark.parametrize("total,threshold", [
    (0, 4096), (4096, 4096), (1 << 20, 4096), (1 << 30, 16 << 20),
    (10 ** 12, 1)])
def test_choose_partitions_equals_the_reference(total, threshold):
    assert t_spill.choose_partitions(total, threshold) == \
        j_spill.choose_partitions(total, threshold)
