"""The port's multi-host plane (``presto1_tpu_torch/server/worker.py``,
``exec/dist_engine.py``, ``exec/stage_dag.py``, ``testing/dist_runner.py``)
on the CPU: a coordinator and two worker processes
(``python -m presto1_tpu_torch.server.worker --device cpu``) over the HTTP
task and results protocol, at TPC-H tiny (SF 0.01).

Twins of ``tests/test_multihost.py``: every statement through the port's
``MultiHostRunner`` is held against the port's ``Engine.sql`` and, for the
reference's own statements, the JAX package's ``Engine.sql`` (and TPC-H Q1,
Q3 and Q6 against the pandas oracle too), with ``assert_frames_match``
(integers exact, floats to 1e-6).  The JAX package's worker processes are
not started here; its pure parts are compared with the port's directly:
``build_stage_dag`` (the same stages, partitioning and broadcast
decisions), ``plan_to_json`` (the same JSON), and ``_key_hash_host`` /
``_partition_output`` (the same destination for every row).  Then the
reference defect C24 (a worker uploads the tables under its remote
sources) on in-process workers.

Every runner is module-scoped (each spawns processes), every wait is
bounded, and every worker is killed when its runner closes.
"""

import json
import time
from urllib import request as urlrequest

import numpy as np
import pytest
import torch

import presto1_tpu.exec.catalog as j_catalog
import presto1_tpu.exec.engine as j_engine
import presto1_tpu_torch.exec.catalog as t_catalog
import presto1_tpu_torch.exec.engine as t_engine
from presto1_tpu_torch.exec.dist_engine import MultiHostEngine, QueryFailed
from presto1_tpu_torch.testing.dist_runner import (DiscoveryServer,
                                                   MultiHostRunner)
from presto1_tpu_torch.tpch.queries import QUERIES
from presto1_tpu_torch.tpch.schema import TABLES

from test_tpch import assert_frames_match
from tpch_oracle import ORACLE

torch.set_num_threads(1)

def _runner(**kw):
    return MultiHostRunner(n_workers=2, catalog_spec="tpch:tiny",
                           device="cpu", **kw)


@pytest.fixture(scope="module")
def runner():
    # broadcast_threshold=0 forces repartition joins so the FIXED_HASH
    # worker-to-worker exchange is what these tests exercise; the broadcast
    # path has its own engine below (same workers)
    with _runner(shards_per_node=2, broadcast_threshold=0) as r:
        yield r


@pytest.fixture(scope="module")
def broadcast_engine(runner):
    """A second coordinator over the SAME worker fleet with broadcast
    replication enabled for small build sides."""
    return MultiHostEngine(t_catalog.TpchCatalog("tiny", device="cpu"),
                           runner.registry, shards_per_node=2,
                           broadcast_threshold=100_000, device="cpu")


@pytest.fixture(scope="module")
def local_engine():
    return t_engine.Engine(t_catalog.TpchCatalog("tiny", device="cpu"),
                           device="cpu")


@pytest.fixture(scope="module")
def ref_engine():
    return j_engine.Engine(j_catalog.TpchCatalog("tiny"))


def _pd(batch):
    return batch.to_pandas()


def _both(got, local_engine, ref_engine, sql, ordered):
    """``got`` (a frame) equals the port's and the JAX package's
    ``Engine.sql``."""
    assert_frames_match(got, local_engine.sql_pandas(sql), ordered=ordered)
    assert_frames_match(got, ref_engine.sql_pandas(sql), ordered=ordered)


QUERIES_TO_RUN = [
    "select count(*) from lineitem",
    "select sum(l_quantity), min(l_shipdate), max(l_shipdate), "
    "avg(l_extendedprice) from lineitem",
    # partial/final group aggregation over the wire
    "select l_returnflag, l_linestatus, sum(l_quantity), count(*), "
    "avg(l_discount) from lineitem group by l_returnflag, l_linestatus "
    "order by l_returnflag, l_linestatus",
    # scan-chain fragments + coordinator join
    "select o_orderpriority, count(*) as c from orders "
    "where o_orderdate >= date '1995-01-01' "
    "group by o_orderpriority order by o_orderpriority",
    # join across shipped scan chains
    "select n_name, count(*) from nation, region "
    "where n_regionkey = r_regionkey and r_name = 'ASIA' "
    "group by n_name order by n_name",
]


@pytest.mark.parametrize("sql", QUERIES_TO_RUN)
def test_multihost_matches_local(runner, local_engine, ref_engine, sql):
    _both(runner.sql_pandas(sql), local_engine, ref_engine, sql,
          ordered="order by" in sql)


@pytest.fixture(scope="module")
def frames():
    cat = t_catalog.TpchCatalog("tiny", device="cpu")
    return {t: cat.table(t).batch().to_pandas() for t in TABLES}


@pytest.mark.parametrize("q", [1, 6])
def test_tpch_q1_q6_multihost(runner, local_engine, ref_engine, frames, q):
    got = runner.sql_pandas(QUERIES[q])
    _both(got, local_engine, ref_engine, QUERIES[q], ordered=True)
    assert_frames_match(got, ORACLE[q](frames), ordered=True)


def test_worker_to_worker_exchange_join(runner, local_engine, ref_engine,
                                        frames):
    """The join executes ON WORKERS: stage-1 tasks fill FIXED_HASH
    partitioned output buffers, stage-2 tasks pull co-partitioned buffers
    from their peers and join; the coordinator only unions joined pages."""
    info = {}
    got = _pd(runner.engine.sql(QUERIES[3], info=info))
    _both(got, local_engine, ref_engine, QUERIES[3], ordered=True)
    assert_frames_match(got, ORACLE[3](frames), ordered=True)
    assert info["exchange_tasks"] >= 2, info
    assert info["stage1_tasks"] >= 4, info  # both join sides, all shards


def test_exchange_join_simple(runner, local_engine, ref_engine):
    sql = ("select c_mktsegment, count(*) c from customer, orders "
           "where c_custkey = o_custkey group by c_mktsegment "
           "order by c_mktsegment")
    info = {}
    got = _pd(runner.engine.sql(sql, info=info))
    _both(got, local_engine, ref_engine, sql, ordered=True)
    assert info["exchange_tasks"] >= 2, info


def test_node_registry_sees_workers(runner):
    nodes = runner.registry.active_nodes()
    assert len(nodes) == 2
    assert all(n.success_rate > 0.5 for n in nodes)
    for n in nodes:  # every worker computes on the device it was given
        with urlrequest.urlopen(f"{n.uri}/v1/status", timeout=10) as resp:
            assert json.loads(resp.read().decode())["device"] == "cpu"


def test_worker_failure_fails_query_then_excluded():
    """No task retry: a dead worker fails the query; the heartbeat detector
    then excludes the node and later queries run on the survivor."""
    with _runner() as r:
        baseline = r.sql_pandas("select count(*) from nation")
        assert int(np.asarray(baseline.iloc[0, 0])) == 25
        r.kill_worker(1)
        # in-flight/new queries against the dead node fail (no retry)
        with pytest.raises(QueryFailed):
            for _ in range(5):
                r.sql("select count(*) from lineitem")
                time.sleep(0.1)
        # wait for the failure detector to mark the node dead
        deadline = time.time() + 15
        while time.time() < deadline:
            if len(r.registry.active_nodes()) == 1:
                break
            time.sleep(0.2)
        assert len(r.registry.active_nodes()) == 1
        # queries now schedule on the survivor and succeed
        out = r.sql_pandas("select count(*) from nation")
        assert int(np.asarray(out.iloc[0, 0])) == 25
        assert r.workers[1].poll() is not None
    assert all(p.poll() is not None for p in r.workers)


def test_page_serde_roundtrip():
    from presto1_tpu_torch.batch import Column, RecordBatch
    from presto1_tpu_torch.exec.pages import (deserialize_batch,
                                              serialize_batch)
    from presto1_tpu_torch.types import BIGINT, VARCHAR, DecimalType

    dictionary = np.array(["ash", "birch", "cedar"], dtype="U")
    b = RecordBatch({
        "k": Column(torch.tensor([1, 2, 3, 4], dtype=torch.int64), BIGINT),
        "m": Column(torch.tensor([100, -5, 0, 7], dtype=torch.int64),
                    DecimalType(12, 2),
                    validity=torch.tensor([True, True, False, True])),
        "s": Column(torch.tensor([2, 0, 1, 0], dtype=torch.int32), VARCHAR,
                    dictionary=dictionary),
    }, 4)
    rt = deserialize_batch(serialize_batch(b))
    assert rt.num_rows == 4
    assert rt["k"].data.tolist() == [1, 2, 3, 4]
    assert rt["m"].type == DecimalType(12, 2)
    assert rt["m"].validity.tolist() == [True, True, False, True]
    assert list(rt["s"].dictionary) == ["ash", "birch", "cedar"]
    assert rt["s"].data.tolist() == [2, 0, 1, 0]


# scan-domain bounds the port keeps in the column's unit where the JAX
# package keeps the literal's (ROADMAP C28): by query, the columns whose
# bounds the reference's plan holds divided by this factor (Q6's
# ``l_quantity < 24`` on a decimal(12,2) column is 2400 unscaled)
C28_BOUND_FACTORS = {6: {"l_quantity": 100}}


def _c28(plan_json, q):
    """The JAX package's plan JSON with its scan-domain bounds in the
    column's unit, as the port's are (``C28_BOUND_FACTORS``)."""
    factors = C28_BOUND_FACTORS.get(q, {})

    def walk(x):
        if isinstance(x, dict):
            if x.get("k") == "scan" and x.get("domain"):
                for col, d in x["domain"]["domains"].items():
                    f = factors.get(col)
                    if f is not None:
                        for k in ("lo", "hi"):
                            if d[k] is not None:
                                d[k] *= f
            for v in x.values():
                walk(v)
        elif isinstance(x, list):
            for v in x:
                walk(v)
        return x

    return walk(plan_json)


@pytest.mark.parametrize("q", sorted(QUERIES))
def test_plan_serde_matches_reference(q):
    """``plan_to_json`` of both packages on the same statement: the same
    JSON (scan-domain bounds in the column's unit, C28); and the port's
    round trip renders the same tree."""
    from presto1_tpu.sql.serde import plan_to_json as j_json
    from presto1_tpu_torch.sql.logical import plan_tree
    from presto1_tpu_torch.sql.serde import plan_from_json, plan_to_json

    port = t_engine.Engine(_T_CAT, device="cpu").plan(QUERIES[q])
    ref = j_engine.Engine(_J_CAT).plan(QUERIES[q])
    assert json.dumps(plan_to_json(port), sort_keys=True) == \
        json.dumps(_c28(j_json(ref), q), sort_keys=True)
    assert plan_tree(plan_from_json(plan_to_json(port))) == plan_tree(port)


_T_CAT = t_catalog.TpchCatalog("tiny", device="cpu")
_J_CAT = j_catalog.TpchCatalog("tiny")


def _stage_summary(stages, to_json):
    return json.dumps([
        (st.sid, st.distribution, st.table, st.partition_keys,
         [(s.stub_path, s.stage, s.mode) for s in st.sources],
         st.collect_domains, st.df, repr(st.sorted_by), st.skew,
         to_json(st.plan)) for st in stages], sort_keys=True, default=str)


@pytest.mark.parametrize("skew", [False, True], ids=["plain", "skew"])
@pytest.mark.parametrize("broadcast", [0, 100_000],
                         ids=["repartition", "broadcast"])
@pytest.mark.parametrize("q", sorted(QUERIES))
def test_stage_dag_matches_reference(q, broadcast, skew):
    """``build_stage_dag`` of both packages on the same logical plan: the
    same stages (distribution, table, partition keys, remote sources and
    their modes, dynamic-filter and skew links, sort keys, stage plans),
    the same coordinator plan and the same stub paths (scan-domain bounds
    in the column's unit, C28)."""
    import presto1_tpu.exec.stage_dag as j_dag
    from presto1_tpu.sql.serde import plan_to_json as j_json
    import presto1_tpu_torch.exec.stage_dag as t_dag
    from presto1_tpu_torch.sql.serde import plan_to_json as t_json

    port = t_engine.Engine(_T_CAT, device="cpu").plan(QUERIES[q])
    ref = j_engine.Engine(_J_CAT).plan(QUERIES[q])
    a = t_dag.build_stage_dag(port, _T_CAT, broadcast_threshold=broadcast,
                              skew=skew)
    b = j_dag.build_stage_dag(ref, _J_CAT, broadcast_threshold=broadcast,
                              skew=skew)
    assert a[1] == b[1]
    assert json.dumps(t_json(a[0]), sort_keys=True) == \
        json.dumps(_c28(j_json(b[0]), q), sort_keys=True)
    assert _stage_summary(a[2], t_json) == _stage_summary(
        b[2], lambda p: _c28(j_json(p), q))


def _hash_batches(seed: int):
    """The same rows as a port batch and a JAX-package batch: an int64 key
    with NULLs and zeros, a float64 key, and a varchar key whose two halves
    come with dictionaries of different widths."""
    import jax.numpy as jnp

    from presto1_tpu.batch import Column as JColumn, RecordBatch as JBatch
    from presto1_tpu.types import BIGINT as JB, DOUBLE as JD, VARCHAR as JV
    from presto1_tpu_torch.batch import Column, RecordBatch
    from presto1_tpu_torch.types import BIGINT, DOUBLE, VARCHAR

    rng = np.random.default_rng(seed)
    n = 500
    k = rng.integers(-3, 4, n).astype(np.int64)
    kv = rng.random(n) > 0.2
    f = np.round(rng.normal(size=n), 1)
    words = np.array(["FRANCE", "GERMANY", "IRAQ", "UNITED KINGDOM", ""],
                     dtype="U")
    s = rng.integers(0, len(words), n).astype(np.int32)
    sv = rng.random(n) > 0.1
    port = RecordBatch({
        "k": Column(torch.from_numpy(k), BIGINT,
                    validity=torch.from_numpy(kv)),
        "f": Column(torch.from_numpy(f), DOUBLE),
        "s": Column(torch.from_numpy(s), VARCHAR, dictionary=words,
                    validity=torch.from_numpy(sv))}, n)
    ref = JBatch({
        "k": JColumn(jnp.asarray(k), JB, validity=jnp.asarray(kv)),
        "f": JColumn(jnp.asarray(f), JD),
        "s": JColumn(jnp.asarray(s), JV, dictionary=words,
                     validity=jnp.asarray(sv))}, n)
    return port, ref, n


@pytest.mark.parametrize("keys", [["k"], ["f"], ["s"], ["k", "s"],
                                  ["s", "f", "k"]],
                         ids=lambda k: "+".join(k))
def test_key_hash_matches_reference(keys):
    from presto1_tpu.server import worker as j_worker
    from presto1_tpu_torch.server import worker as t_worker

    port, ref, n = _hash_batches(7)
    a = t_worker._key_hash_host(port, n, keys)
    b = j_worker._key_hash_host(ref, n, keys)
    assert a.dtype == b.dtype == np.uint64
    assert np.array_equal(a, b)


def _rows_of_buffers(buffers, to_rows):
    from presto1_tpu_torch.exec.pages import deserialize_batch

    out = []
    for pages in buffers:
        rows = []
        for page in pages:
            rows.extend(to_rows(deserialize_batch(page)))
        out.append(rows)
    return out


@pytest.mark.parametrize("mode", ["plain", "hot", "hot_build"])
def test_partition_output_matches_reference(mode):
    """``_partition_output`` of both packages on the same batch: every row
    in the same destination buffer, in the same order (NULL keys and string
    dictionaries included), and the same hot hashes reported."""
    from presto1_tpu.server import worker as j_worker
    from presto1_tpu_torch.server import worker as t_worker

    port, ref, n = _hash_batches(11)
    kw = {}
    if mode == "hot":
        kw["collect_hot"] = 0.3
    hot = None
    if mode == "hot_build":
        h = t_worker._key_hash_host(port, n, ["k"])
        hot = [int(h[0]), int(h[5])]
        kw["hot_hashes"] = hot
    tt, jt = t_worker.WorkerTask("a"), j_worker.WorkerTask("b")
    a = t_worker._partition_output(port, n, ["k"], 3, task=tt, **kw)
    b = j_worker._partition_output(ref, n, ["k"], 3, task=jt, **kw)

    def rows(batch):
        return [tuple(r) for r in batch.to_pylist()]

    assert len(a) == len(b) == 3
    assert _rows_of_buffers(a, rows) == _rows_of_buffers(b, rows)
    assert tt.hot_keys == jt.hot_keys
    if mode == "hot":
        assert tt.hot_keys  # the skewed key values were found hot


def test_string_hash_width_and_padding_independent():
    """Cross-host determinism of the dictionary hash: two hosts hold the
    same values in dictionaries of different fixed widths, and the hash
    must not see the padding."""
    from presto1_tpu_torch.server.worker import _hash_strings_host

    a = np.array(["FRANCE", "GERMANY", "IRAQ"], dtype="U7")
    b = np.array(["FRANCE", "GERMANY", "IRAQ", "UNITED KINGDOM"],
                 dtype="U14")
    ha, hb = _hash_strings_host(a), _hash_strings_host(b)
    assert (ha == hb[:3]).all()
    assert len(set(hb.tolist())) == 4  # no collisions among distinct values
    assert _hash_strings_host(np.array(["x"], dtype="U32"))[0] == \
        _hash_strings_host(np.array(["x"], dtype="U1"))[0]
    assert len(_hash_strings_host(np.array([], dtype="U1"))) == 0


def test_null_keys_hash_apart_from_zero():
    """NULL lanes must not co-hash with legitimate 0-valued keys."""
    from presto1_tpu_torch.batch import Column, RecordBatch
    from presto1_tpu_torch.server.worker import _key_hash_host
    from presto1_tpu_torch.types import BIGINT

    b = RecordBatch({"k": Column(torch.tensor([0, 0, 5]), BIGINT,
                                 validity=torch.tensor([True, False,
                                                        True]))}, 3)
    h = _key_hash_host(b, 3, ["k"])
    assert h[0] != h[1]  # value-0 row vs NULL row


# ---------------------------------------------------------------- stage DAG


def test_multistage_q3_runs_on_workers(runner, local_engine):
    """A join-over-join query (Q3 shape) executes ENTIRELY on workers as a
    recursive stage DAG, and the coordinator pulls only the final grouped
    rows."""
    info = {}
    got = _pd(runner.engine.sql(QUERIES[3], info=info))
    assert_frames_match(got, local_engine.sql_pandas(QUERIES[3]),
                        ordered=True)
    assert info["stages"] >= 4, info          # 2 scans + join + final agg
    assert info["exchange_tasks"] >= 8, info  # join + final-agg stages
    assert info["coordinator_bytes"] < 200_000, info


def test_multistage_three_table_join_grouped(runner, local_engine,
                                             ref_engine):
    """Q5-class: 3+ joins, group-by over the join tree, all on workers."""
    sql = ("select n_name, count(*) c, sum(l_extendedprice) s "
           "from customer, orders, lineitem, nation "
           "where c_custkey = o_custkey and l_orderkey = o_orderkey "
           "and c_nationkey = n_nationkey "
           "group by n_name order by n_name")
    info = {}
    got = _pd(runner.engine.sql(sql, info=info))
    _both(got, local_engine, ref_engine, sql, ordered=True)
    assert info["stages"] >= 5, info


def test_broadcast_join_distribution(broadcast_engine, runner, local_engine,
                                     ref_engine):
    """A small build side is replicated to every probe task — no
    FIXED_HASH repartition of the big side at all."""
    sql = ("select n_name, count(*) c from supplier, nation "
           "where s_nationkey = n_nationkey group by n_name order by n_name")
    info = {}
    got = _pd(broadcast_engine.sql(sql, info=info))
    _both(got, local_engine, ref_engine, sql, ordered=True)
    assert info["broadcast_sources"] >= 1, info
    info_part = {}
    b = _pd(runner.engine.sql(sql, info=info_part))
    assert_frames_match(b, got, ordered=True)
    assert info_part["broadcast_sources"] == 0, info_part


def test_broadcast_left_outer_and_semi(broadcast_engine, local_engine,
                                       ref_engine):
    for sql in [
        "select c_mktsegment, count(o_orderkey) c from customer "
        "left join orders on c_custkey = o_custkey "
        "group by c_mktsegment order by c_mktsegment",
        "select count(*) from lineitem where l_orderkey in "
        "(select o_orderkey from orders where o_orderpriority = '1-URGENT')",
    ]:
        _both(_pd(broadcast_engine.sql(sql)), local_engine, ref_engine, sql,
              ordered=False)


def test_distributed_topn(runner, local_engine, ref_engine):
    """Every task sorts + truncates its partition, the coordinator merges
    supersets — the wire carries ~limit rows per task."""
    sql = ("select l_orderkey, l_extendedprice from lineitem "
           "order by l_extendedprice desc, l_orderkey limit 10")
    info = {}
    got = _pd(runner.engine.sql(sql, info=info))
    _both(got, local_engine, ref_engine, sql, ordered=True)
    assert info["coordinator_bytes"] < 100_000, info
    assert info["sorted_stages"] >= 1, info


def test_skew_aware_repartition_join(runner, local_engine):
    """Engineered-skew repartition join: l_linenumber has 7 values with
    ~25% of rows on value 1.  With skew handling the probe stage reports
    hot hashes, scatters those rows round-robin, and the build stage
    replicates its hot rows into every buffer — the hottest join task's
    input shrinks and results stay exact."""
    sql = ("select l_linenumber, count(*) c, sum(l_quantity) q "
           "from lineitem, nation where l_linenumber = n_nationkey "
           "group by l_linenumber order by l_linenumber")
    expected = local_engine.sql_pandas(sql)

    def run(skew_threshold):
        eng = MultiHostEngine(t_catalog.TpchCatalog("tiny", device="cpu"),
                              runner.registry, shards_per_node=2,
                              broadcast_threshold=0, dynamic_filtering=False,
                              skew_threshold=skew_threshold, device="cpu")
        info = {}
        out = _pd(eng.sql(sql, info=info))
        assert_frames_match(out, expected, ordered=True)
        join_stage = next(ss for ss in info["stage_stats"]
                          if ss["distribution"] == "hash"
                          and len(ss["taskBytesIn"]) > 0
                          and max(ss["taskBytesIn"]) > 0)
        return info, join_stage["taskBytesIn"]

    info_off, bytes_off = run(skew_threshold=0.0)
    info_on, bytes_on = run(skew_threshold=0.7)
    assert info_off["skew_joins"] == 0
    assert info_on["skew_joins"] >= 1, info_on
    assert max(bytes_on) < max(bytes_off), (bytes_on, bytes_off)


def test_skew_multi_key(runner, local_engine, ref_engine):
    """Multi-key skew rides the same row-hash mechanism."""
    sql = ("select count(*) c from lineitem, partsupp "
           "where l_linenumber = ps_availqty and l_suppkey = ps_suppkey")
    eng = MultiHostEngine(t_catalog.TpchCatalog("tiny", device="cpu"),
                          runner.registry, shards_per_node=2,
                          broadcast_threshold=0, dynamic_filtering=False,
                          skew_threshold=0.7, device="cpu")
    _both(_pd(eng.sql(sql)), local_engine, ref_engine, sql, ordered=False)


def test_distributed_dynamic_filtering(runner, local_engine, ref_engine):
    """The build side runs first with domain collection; the merged key
    [min,max] is pushed into the probe fragments, so probe rows outside the
    build domain are dropped on the workers before the exchange."""
    sql = ("select sum(l_extendedprice) s from lineitem, orders "
           "where l_orderkey = o_orderkey "
           "and o_orderkey between 500 and 600")
    info_on = {}
    a = _pd(runner.engine.sql(sql, info=info_on))
    _both(a, local_engine, ref_engine, sql, ordered=False)
    assert info_on["df_applied"], info_on
    eng_off = MultiHostEngine(runner.engine.catalog, runner.registry,
                              shards_per_node=runner.engine.shards_per_node,
                              dynamic_filtering=False,
                              broadcast_threshold=0, device="cpu")
    info_off = {}
    b = _pd(eng_off.sql(sql, info=info_off))
    assert_frames_match(b, a, ordered=False)
    assert not info_off["df_applied"]
    assert 0 < info_on["exchange_bytes_in"] < info_off["exchange_bytes_in"], \
        (info_on, info_off)


def test_exchange_overlap_pipelines_stages(runner, local_engine):
    """Every upstream buffer pulls concurrently and a downstream task's
    exchange wait overlaps upstream execution, with the tasks of all stages
    created up front.  Witness: total query wall < sum of per-stage walls.
    Dynamic filtering is off here: with it the scheduler runs each build
    stage to its end before it creates the probe stage's tasks, so those
    stages do not overlap, and under load the waits between them can make
    the wall exceed the sum."""
    sql = ("select c_mktsegment, count(*) c, sum(l_extendedprice) v "
           "from customer, orders, lineitem "
           "where c_custkey = o_custkey and o_orderkey = l_orderkey "
           "group by c_mktsegment order by c_mktsegment")
    eng = MultiHostEngine(runner.engine.catalog, runner.registry,
                          shards_per_node=2, broadcast_threshold=0,
                          dynamic_filtering=False, device="cpu")
    info = {}
    got = _pd(eng.sql(sql, info=info))
    assert_frames_match(got, local_engine.sql_pandas(sql), ordered=True)
    walls = [ss["wallMs"] for ss in info["stage_stats"]]
    assert len(walls) >= 3, info["stage_stats"]
    assert info["wall_ms"] < sum(walls), (info["wall_ms"], walls)
    fetches = [ss["fetchMs"] for ss in info["stage_stats"]
               if ss["distribution"] == "hash"]
    assert fetches and max(fetches) > 0, info["stage_stats"]


def test_distributed_order_by_merges(runner, local_engine, ref_engine):
    """Per-task sorts are consumed by the coordinator's k-way merge: the
    coordinator plan holds a MergeSorted node, never a re-sort."""
    sql = ("select l_orderkey, l_extendedprice, l_shipdate from lineitem "
           "where l_quantity < 10 "
           "order by l_extendedprice desc, l_orderkey")
    info = {}
    got = _pd(runner.engine.sql(sql, info=info))
    _both(got, local_engine, ref_engine, sql, ordered=True)
    assert info["merged_stages"] >= 1, info
    lines = info["coordinator_plan"].split("\n")
    assert lines[1].strip().startswith("MergeSorted"), \
        info["coordinator_plan"]


def test_merge_sorted_batches_unit():
    """k-way merge over engineered runs: multi-key, DESC, NULLs, strings
    (union-dictionary recode keeps code order comparable)."""
    import pandas as pd

    from presto1_tpu_torch.batch import Column, RecordBatch
    from presto1_tpu_torch.exec.merge import merge_sorted_batches
    from presto1_tpu_torch.expr import ir
    from presto1_tpu_torch.types import BIGINT, DOUBLE, VARCHAR

    rng = np.random.default_rng(3)
    keys = [(ir.ColumnRef("a", DOUBLE), False, False),
            (ir.ColumnRef("s", VARCHAR), True, None),
            (ir.ColumnRef("b", BIGINT), True, None)]
    words = np.array(["ape", "bee", "cat", "dog", "eel"])
    frames, runs = [], []
    for _ in range(5):
        n = int(rng.integers(1, 200))
        a = np.round(rng.normal(size=n), 1)
        a = np.where(a == 0, 0.0, a)
        av = rng.random(n) > 0.1
        s = rng.integers(0, 5, n)
        b = rng.integers(-10, 10, n).astype(np.int64)
        df = pd.DataFrame({"a": np.where(av, a, np.nan),
                           "s": words[s], "b": b})
        df = df.sort_values(["a", "s", "b"], ascending=[False, True, True],
                            na_position="last", kind="stable")
        frames.append(df)
        d, codes = np.unique(words[s.take(df.index)], return_inverse=True)
        runs.append(RecordBatch(
            {"a": Column(torch.from_numpy(df.a.fillna(0.0).to_numpy()),
                         DOUBLE,
                         validity=torch.from_numpy(~df.a.isna().values)),
             "s": Column(torch.from_numpy(codes.astype(np.int32)), VARCHAR,
                         dictionary=d),
             "b": Column(torch.from_numpy(df.b.to_numpy()), BIGINT)},
            len(df)))
    out = merge_sorted_batches(runs, keys, device="cpu").to_pandas()
    exp = pd.concat(frames).sort_values(
        ["a", "s", "b"], ascending=[False, True, True],
        na_position="last", kind="stable").reset_index(drop=True)
    assert list(out.s) == list(exp.s)
    assert list(out.b) == list(exp.b)
    a_out = out.a.astype(float)
    both_nan = a_out.isna().values & exp.a.isna().values
    assert np.all(both_nan | np.isclose(a_out.fillna(0), exp.a.fillna(0)))


def test_distinct_agg_distributes_by_group(runner, local_engine, ref_engine):
    """count(distinct) with group keys: repartition on the group keys
    co-locates each group wholly, so the distinct aggregate is exact on
    workers."""
    sql = ("select l_returnflag, count(distinct l_suppkey) d "
           "from lineitem group by l_returnflag order by l_returnflag")
    info = {}
    got = _pd(runner.engine.sql(sql, info=info))
    _both(got, local_engine, ref_engine, sql, ordered=True)
    assert info["exchange_tasks"] >= 4, info


def test_multiple_distinct_aggregates_multihost(runner, local_engine,
                                                ref_engine):
    """Multiple count(distinct) per SELECT: MarkDistinct runs inside the
    FIXED_HASH stage after a group-key repartition."""
    sql = ("select l_returnflag, count(distinct l_suppkey) s, "
           "count(distinct l_partkey) p, sum(l_quantity) q "
           "from lineitem group by l_returnflag order by l_returnflag")
    info = {}
    got = _pd(runner.engine.sql(sql, info=info))
    _both(got, local_engine, ref_engine, sql, ordered=True)
    assert info["exchange_tasks"] >= 4, info


def test_approx_distinct_merges_across_hosts(runner, local_engine,
                                             ref_engine):
    """HLL registers merge by max through the partial/final split, so the
    multihost estimate equals the single-host one."""
    for sql in [
        "select approx_distinct(l_suppkey) d from lineitem",
        "select l_returnflag f, approx_distinct(l_partkey) d from lineitem "
        "group by l_returnflag order by l_returnflag",
    ]:
        _both(runner.sql_pandas(sql), local_engine, ref_engine, sql,
              ordered="order by" in sql)


def test_distributed_explain_analyze(runner):
    """Operator stats ship in task info and merge per stage into an EXPLAIN
    ANALYZE rendering."""
    info = {}
    runner.engine.sql(
        "select c_mktsegment, count(*) c from customer, orders "
        "where c_custkey = o_custkey group by c_mktsegment", info=info)
    ss = info["stage_stats"]
    assert len(ss) == info["stages"]
    for stage in ss:
        assert stage["operators"], stage
        assert sum(op["rows"] for op in stage["operators"]) > 0
        assert all(op["tasks"] == stage["tasks"]
                   for op in stage["operators"])
    text = runner.engine.explain_analyze(
        "select count(*) from lineitem where l_quantity < 10")
    assert "Stage 0" in text and "Aggregate" in text and "ms across" in text


def _stage_dag_for(sql, broadcast_threshold=0, skew=False):
    from presto1_tpu_torch.exec.stage_dag import build_stage_dag

    plan = t_engine.Engine(_T_CAT, device="cpu").plan(sql)
    return build_stage_dag(plan, _T_CAT,
                           broadcast_threshold=broadcast_threshold,
                           skew=skew)


def test_full_join_registers_no_partition_alts():
    """A repartitioned FULL join's output carries NULL-extended keys on
    BOTH sides scattered across hash partitions — downstream aggregates
    must NOT run co-grouped in the join stage."""
    inner = ("select n_nationkey, count(*) c from nation join supplier "
             "on n_nationkey = s_nationkey group by n_nationkey")
    full = ("select n_nationkey, count(*) c from nation full join supplier "
            "on n_nationkey = s_nationkey group by n_nationkey")
    _, _, inner_stages = _stage_dag_for(inner)
    _, _, full_stages = _stage_dag_for(full)
    assert len(full_stages) > len(inner_stages)
    assert any(st.partition_keys and len(st.partition_keys) == 1
               and st.partition_keys[0].startswith("n_nationkey")
               and st.distribution == "hash" for st in full_stages)


def test_full_join_null_group_multihost(runner, local_engine, ref_engine):
    """Unmatched build rows (NULL left keys) aggregate into ONE NULL group
    across tasks."""
    sql = ("select n_nationkey, count(*) c from "
           "(select * from nation where n_nationkey < 10) n "
           "full join supplier on n_nationkey = s_nationkey "
           "group by n_nationkey order by n_nationkey")
    _both(_pd(runner.engine.sql(sql)), local_engine, ref_engine, sql,
          ordered=True)


def test_array_column_through_partitioned_exchange(runner, local_engine,
                                                   ref_engine):
    """Nested columns keep their lengths through the partitioned
    exchange (a nested remote input runs on the eager route, counted)."""
    sql = ("select n_name, sum(cardinality(filter(a, x -> x >= 50))) c "
           "from (select s_nationkey k, array[s_suppkey, s_nationkey] a "
           "      from supplier) t "
           "join nation on k = n_nationkey "
           "group by n_name order by n_name")
    _both(_pd(runner.engine.sql(sql)), local_engine, ref_engine, sql,
          ordered=True)


def _worker_metric(runner, name):
    total = 0.0
    for node in runner.registry.active_nodes():
        with urlrequest.urlopen(f"{node.uri}/v1/metrics", timeout=10) as resp:
            snap = json.loads(resp.read().decode())
        for m in snap["metrics"]:
            if m["name"] == name:
                total += m["total"]
    return total


def test_worker_compiled_fragments(runner, local_engine):
    """Workers execute repeated fragments via cached compiled programs:
    policy 'auto' compiles on the second sighting of a (fragment, shard,
    stub-shape) signature; results stay row-identical and the per-worker
    compiled-run counter rises.  The kernel launch counters are served
    beside it (0 on the CPU: there a wrapper runs its plain version)."""
    sql = ("select l_returnflag, count(*) c, sum(l_quantity) s "
           "from lineitem, orders where l_orderkey = o_orderkey "
           "and o_orderdate >= date '1995-01-01' "
           "group by l_returnflag order by l_returnflag")
    expected = local_engine.sql_pandas(sql)
    before = _worker_metric(runner, "worker.compiled_task_runs")
    for _ in range(3):
        assert_frames_match(_pd(runner.engine.sql(sql)), expected,
                            ordered=True)
    after = _worker_metric(runner, "worker.compiled_task_runs")
    assert after > before, (before, after)
    assert _worker_metric(runner, "worker.tasks_failed") == 0
    for fam in ("filter_sum", "dense_group_agg", "gather", "compact"):
        assert _worker_metric(runner, f"kernel.{fam}.launches") == 0


def test_global_distinct_marks_on_workers(runner, local_engine, ref_engine):
    """GLOBAL count(distinct): the MarkDistinct stage repartitions on the
    marker keys and marks on WORKERS."""
    from presto1_tpu_torch.exec.stage_dag import build_stage_dag
    from presto1_tpu_torch.sql.logical import MarkDistinct

    sql = ("select count(distinct l_suppkey) d, sum(distinct l_suppkey) q "
           "from lineitem")
    info = {}
    got = _pd(runner.engine.sql(sql, info=info))
    _both(got, local_engine, ref_engine, sql, ordered=True)
    assert info["exchange_tasks"] >= 4, info

    plan = local_engine.plan(sql)
    local_plan, sources, stages = build_stage_dag(plan,
                                                  local_engine.catalog)[:3]

    def has_md(n):
        return isinstance(n, MarkDistinct) or any(
            has_md(c) for c in n.children)

    def md_path(n, path=()):
        if isinstance(n, MarkDistinct):
            return path
        for i, c in enumerate(n.children):
            p = md_path(c, path + (i,))
            if p is not None:
                return p
        return None

    assert any(has_md(s.plan) for s in stages)
    mdp = md_path(local_plan)
    assert mdp is not None
    assert any(mdp[:len(p)] == tuple(p) for p in sources), (
        mdp, list(sources))


def test_topology_aware_node_selector():
    """Rack labels announced by workers interleave task placement across
    racks; unlabeled clusters keep uniform round-robin."""
    from presto1_tpu_torch.server.discovery import (
        NodeInfo, NodeRegistry, TopologyAwareNodeSelector,
        make_node_selector,
    )

    reg = NodeRegistry()
    for i, rack in enumerate(["r1", "r1", "r2", "r2"]):
        reg.announce(f"n{i}", f"http://w{i}", "tpch:tiny",
                     topology={"rack": rack})
    nodes = reg.all_nodes()
    sel = make_node_selector(nodes)
    assert isinstance(sel, TopologyAwareNodeSelector)
    ordered = sel.order(nodes)
    assert [n.topology["rack"] for n in ordered] == ["r1", "r2", "r1", "r2"]
    plain = [NodeInfo(f"p{i}", f"http://p{i}", "t") for i in range(3)]
    assert [n.node_id for n in TopologyAwareNodeSelector().order(plain)] \
        == ["p0", "p1", "p2"]


# ------------------------------------------- C24, on in-process workers


@pytest.fixture(scope="module")
def in_process():
    """A coordinator engine over two ``WorkerServer``s in this process
    (announcing to a ``DiscoveryServer``), so their catalogs can be read."""
    from presto1_tpu_torch.server.discovery import NodeRegistry
    from presto1_tpu_torch.server.worker import WorkerServer

    reg = NodeRegistry(probe_interval_s=0.25).start()
    disc = DiscoveryServer(reg).start()
    workers = [WorkerServer("tpch:tiny", device="cpu",
                            coordinator=f"http://127.0.0.1:{disc.port}",
                            announce_interval_s=0.2).start()
               for _ in range(2)]
    try:
        deadline = time.time() + 30
        while len(reg.active_nodes()) < 2 and time.time() < deadline:
            time.sleep(0.05)
        assert len(reg.active_nodes()) == 2
        eng = MultiHostEngine(t_catalog.TpchCatalog("tiny", device="cpu"),
                              reg, broadcast_threshold=0, device="cpu")
        yield eng, workers
    finally:
        for w in workers:
            w.stop()
        reg.stop()
        disc.stop()


def test_worker_never_uploads_tables_under_its_remote_sources_c24(
        in_process, local_engine):
    """A hash stage's plan carries its upstream stages' plans (their Scans
    included) under the stub paths.  The JAX package's worker uploads every
    column those Scans name, whole, from the unsharded catalog
    (``presto1_tpu/server/worker.py:307`` ``_prefetch_scans``, and the
    compiled fragment's ``scan_inputs``); the port's worker reads only the
    Scans outside its stubs, from its shard's catalog: after Q3 over two
    workers no base table holds a column, and each shard view holds only
    its own rows."""
    eng, workers = in_process
    assert_frames_match(_pd(eng.sql(QUERIES[3])),
                        local_engine.sql_pandas(QUERIES[3]), ordered=True)
    for w in workers:
        rt = w.runtime
        base = rt.base_catalog()
        assert all(not t._cache for t in base.tables.values())
        assert rt._shards, "no source stage ran on this worker"
        for view in rt._shards.values():
            for t in view.tables.values():
                for (name, _), col in t._cache.items():
                    assert len(col.data) == t.num_rows < \
                        t.base.num_rows

    # the JAX package's prefetch on the same hash stage uploads whole tables
    import presto1_tpu.exec.stage_dag as j_dag
    from presto1_tpu.server import worker as j_worker

    cat = j_catalog.TpchCatalog("tiny")
    plan = j_engine.Engine(cat).plan(QUERIES[3])
    stages = j_dag.build_stage_dag(plan, cat, broadcast_threshold=0)[2]
    hash_stage = next(s for s in stages if s.distribution == "hash")
    j_worker._prefetch_scans(hash_stage.plan, cat)
    uploaded = {t for t, tb in cat.tables.items() if tb._cache}
    assert uploaded  # whole tables of the upstream stages


def test_hash_stage_compiled_inputs_skip_stubs_c24(local_engine):
    """``CompiledQuery(stubs=)`` collects scan inputs only outside its
    stubs: a hash stage (no scan of its own) has none."""
    from presto1_tpu_torch.exec.executor import CompiledQuery, Executor
    from presto1_tpu_torch.exec.stage_dag import build_stage_dag

    cat = t_catalog.TpchCatalog("tiny", device="cpu")
    plan = local_engine.plan(QUERIES[3])
    _, _, stages = build_stage_dag(plan, cat, broadcast_threshold=0)
    outs = {}
    for st in stages:
        stubs = {s.stub_path: outs[s.stage] for s in st.sources}
        outs[st.sid] = Executor(cat, stubs=stubs,
                                device="cpu").execute(st.plan)
        if st.distribution == "hash":
            cq = CompiledQuery(cat, st.plan, stubs=stubs, device="cpu")
            assert cq.inputs == {}
            assert cq(stubs=stubs).to_pylist() == outs[st.sid].to_pylist()
