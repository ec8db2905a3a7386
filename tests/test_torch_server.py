"""The port's coordinator (``presto1_tpu_torch/server/coordinator.py``) and
its clients (``client/http_client.py``, ``client/dbapi.py``,
``client/cli.py``) on the CPU.

Twins of ``tests/test_server.py``: the statement protocol round trip,
paging, failure, EXPLAIN [ANALYZE] (eager and compiled), events and the
compiled plan cache; every result over HTTP equals the JAX package's
``CoordinatorServer`` in front of its own ``Engine`` on the same catalog
(TPC-H at SF 0.001).  Then the DB-API and CLI clients, and the reference
defect C22: a running query's operator statistics are read (``/v1/query``
and ``/ui/query``) while the query inserts operators.
"""

import json
import threading
import time
import urllib.request

import pytest
import torch

import presto1_tpu.exec.catalog as j_catalog
import presto1_tpu.exec.engine as j_engine
from presto1_tpu.client.http_client import Client as JClient
from presto1_tpu.server.coordinator import CoordinatorServer as JServer
import presto1_tpu_torch.exec.catalog as t_catalog
import presto1_tpu_torch.exec.engine as t_engine
from presto1_tpu_torch.client.http_client import Client, QueryFailed
from presto1_tpu_torch.server.coordinator import CoordinatorServer

torch.set_num_threads(1)

SF = 0.001


def _engine(**kw):
    return t_engine.Engine(t_catalog.TpchCatalog(sf=SF, device="cpu"),
                           device="cpu", **kw)


@pytest.fixture(scope="module")
def server():
    srv = CoordinatorServer(_engine()).start()
    yield srv
    srv.stop()


@pytest.fixture(scope="module")
def ref_server():
    srv = JServer(j_engine.Engine(j_catalog.TpchCatalog(sf=SF))).start()
    yield srv
    srv.stop()


def _both(server, ref_server, sql):
    got = Client(f"http://127.0.0.1:{server.port}").execute(sql)
    want = JClient(f"http://127.0.0.1:{ref_server.port}").execute(sql)
    assert got == want
    return got


def test_statement_roundtrip(server, ref_server):
    cols, rows = _both(
        server, ref_server,
        "select n_name, n_nationkey from nation order by n_nationkey limit 3")
    assert [col["name"] for col in cols] == ["n_name", "n_nationkey"]
    assert rows == [["ALGERIA", 0], ["ARGENTINA", 1], ["BRAZIL", 2]]


@pytest.mark.parametrize("sql", [
    "select count(*) c from customer",
    "select l_returnflag, l_linestatus, sum(l_quantity) q, "
    "min(l_shipdate) d, avg(l_discount) a from lineitem "
    "group by l_returnflag, l_linestatus order by l_returnflag, "
    "l_linestatus",
    "select o_orderpriority, count(*) c, max(o_totalprice) p from orders "
    "group by o_orderpriority order by o_orderpriority",
], ids=["count", "q1_shape", "decimals"])
def test_statement_aggregation(server, ref_server, sql):
    cols, rows = _both(server, ref_server, sql)
    assert rows and rows[0][-1] is not None


def test_statement_failure(server, ref_server):
    for base in (server, ref_server):
        c = Client(f"http://127.0.0.1:{base.port}")
        with pytest.raises(QueryFailed):
            c.execute("select bogus_column from nation")


def test_paged_results(server, ref_server):
    cols, rows = _both(server, ref_server,
                       "select l_orderkey from lineitem")
    assert len(rows) > 1000  # > PAGE_ROWS -> exercises nextUri paging
    assert rows[0][0] >= 1


def test_explain_analyze_render():
    txt = _engine().explain_analyze(
        "select count(*) from lineitem where l_quantity < 10")
    assert "Aggregate" in txt and "ms" in txt


def test_explain_analyze_compiled_path():
    """EXPLAIN ANALYZE on the compiled path: per-fragment walls, rows and
    bytes at the fragment-root plan nodes."""
    from presto1_tpu_torch.exec.session import Session

    s = Session()
    s.set("compile_queries", True)
    txt = _engine(session=s).explain_analyze(
        "select o_orderpriority, count(*) c from orders, customer "
        "where o_custkey = c_custkey and c_acctbal > 0 "
        "group by o_orderpriority order by c desc")
    assert "compiled path" in txt and "fragments" in txt
    assert "MB out" in txt and "Join" in txt
    joins = [ln for ln in txt.splitlines() if "Join" in ln and "ms" in ln]
    assert joins, txt


def test_events():
    from presto1_tpu_torch.exec.events import EventBus

    bus = EventBus()
    seen = []
    bus.register(seen.append)
    _engine(events=bus).sql("select 1 x from region limit 1")
    assert [e.kind for e in seen] == ["created", "completed"]


def test_explain_statement():
    engine = _engine()
    out = engine.execute_statement(
        "explain select count(*) from lineitem where l_quantity < 10")
    text = "\n".join(r[0] for r in out.to_pylist())
    assert "Aggregate" in text and "Filter" in text
    out = engine.execute_statement(
        "explain analyze select count(*) from region")
    assert out.num_rows >= 3


def test_compiled_plan_cache():
    from presto1_tpu_torch.exec.session import Session

    s = Session()
    s.set("compile_queries", True)
    engine = _engine(session=s)
    r1 = engine.sql("select count(*) c from orders").to_pylist()
    r2 = engine.sql("select count(*) c from orders").to_pylist()
    assert r1 == r2
    assert len(engine._compiled_cache) == 1


def test_compiled_coordinator_over_http(ref_server):
    """A coordinator whose engine compiles (``compile_queries``): TPC-H Q1
    and Q6 over HTTP equal the JAX package's coordinator."""
    from presto1_tpu_torch.exec.session import Session
    from presto1_tpu_torch.tpch.queries import QUERIES

    s = Session()
    s.set("compile_queries", True)
    srv = CoordinatorServer(_engine(session=s)).start()
    try:
        for q in (1, 6):
            _both(srv, ref_server, QUERIES[q])
    finally:
        srv.stop()


def test_dbapi_over_http_and_in_process(server, ref_server):
    """PEP 249 over the statement protocol and over an in-process engine:
    the same rows as the JAX package's coordinator."""
    from presto1_tpu_torch.client import dbapi

    sql = ("select r_name, count(*) c from nation, region "
           "where n_regionkey = r_regionkey group by r_name order by r_name")
    want = [tuple(r) for r in JClient(
        f"http://127.0.0.1:{ref_server.port}").execute(sql)[1]]
    conn = dbapi.connect(f"http://127.0.0.1:{server.port}")
    cur = conn.cursor().execute(sql)
    assert [d[0] for d in cur.description] == ["r_name", "c"]
    assert cur.fetchall() == want
    local = dbapi.connect(schema="tiny", device="cpu").cursor()
    local.execute("select count(*) from nation where n_regionkey = ?", [1])
    assert local.fetchone() == (5,)


def test_cli_local_engine_on_the_cpu(capsys):
    from presto1_tpu_torch.client import cli

    cli.main(["--local", "tiny", "--device", "cpu", "-e",
              "select count(*) c from nation"])
    out = capsys.readouterr().out
    assert "25" in out and "(1 rows)" in out


def test_entry_serve_recipe(ref_server):
    """``presto1_tpu_torch.entry.serve``: the README's coordinator recipe
    on the CPU, queried by the HTTP client; the JAX package's answer."""
    from presto1_tpu_torch.entry import serve

    srv = serve("tiny", 0, "cpu")
    try:
        assert str(srv.manager.engine.device) == "cpu"
        got = Client(f"http://127.0.0.1:{srv.port}").execute(
            "select count(*) c from nation")
        assert got == ([{"name": "c", "type": "bigint"}], [[25]])
    finally:
        srv.stop()


def test_entry_points_default_to_cuda():
    """Every entry point of the server plane defaults to the card."""
    import inspect

    from presto1_tpu_torch.client import dbapi
    from presto1_tpu_torch.entry import serve
    from presto1_tpu_torch.exec.dist_engine import MultiHostEngine
    from presto1_tpu_torch.server.config import ServerConfig, build_catalog
    from presto1_tpu_torch.server.worker import WorkerRuntime, WorkerServer
    from presto1_tpu_torch.testing.dist_runner import MultiHostRunner

    for fn in (MultiHostEngine, WorkerRuntime, WorkerServer,
               MultiHostRunner, build_catalog, dbapi.connect, serve):
        assert inspect.signature(fn).parameters["device"].default == "cuda"
    assert ServerConfig().device == "cuda"


# ------------------------------------------------------------------- C22


def test_operator_stats_read_while_the_query_inserts_c22(server):
    """The JAX package's ``ManagedQuery.info`` and ``/ui/query`` read
    ``q.stats.operators`` under no lock the writer takes while the query
    inserts and updates operators (``presto1_tpu/server/coordinator.py:
    57-78,383,391``).  The port's ``QueryStats`` records under the query's
    lock and readers copy under it: 80 reads of both pages while another
    thread inserts 3,000 operators all answer 200 with operators in
    order, and the writer is never blocked for long."""
    from presto1_tpu_torch.exec.session import Session
    from presto1_tpu_torch.exec.stats import QueryStats
    from presto1_tpu_torch.server.coordinator import ManagedQuery

    q = ManagedQuery("c22racequery", "select 1", Session(user="u"))
    q.stats = QueryStats(lock=q.lock)
    q.state = "RUNNING"
    server.manager.queries[q.id] = q
    stop = threading.Event()

    def insert():
        i = 0
        while not stop.is_set() and i < 3_000:
            q.stats.record((i % 97, i), "Op", "", 0.001, i, 128)
            i += 1
            if i % 50 == 0:
                time.sleep(0.002)  # spread the inserts over the reads

    writer = threading.Thread(target=insert)
    writer.start()
    base = f"http://127.0.0.1:{server.port}"
    try:
        for k in range(80):
            path = f"/v1/query/{q.id}" if k % 2 == 0 else f"/ui/query/{q.id}"
            with urllib.request.urlopen(base + path, timeout=30) as resp:
                assert resp.status == 200
                body = resp.read().decode()
            if k % 2 == 0:
                paths = [tuple(map(int, op["path"].split("/")))
                         for op in json.loads(body).get("operators", [])]
                assert paths == sorted(paths)
            else:
                assert "c22racequery" in body
    finally:
        stop.set()
        writer.join(30)
        q.state = "FINISHED"
    assert len(q.stats.items()) > 0
