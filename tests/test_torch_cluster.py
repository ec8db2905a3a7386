"""Trino's multi-node deployment on the port, on the CPU at SF 0.01: a
coordinator with ``node-scheduler.include-coordinator=false`` (in this
process, built from its etc directory) and two worker processes started by
the port's launcher from theirs, every node reading the benchmark's columns
through the connector its catalog properties name by factory
(``perfbench/connector.py``).

The mix's instances and three other sets of Q1, Q6 and Q3, sent through
``Client``, answer as the single-node ``Engine`` and the plain reference
(``perfbench/reference/tpch_q{1,3,6}.py``) do; each FINISHED page names
tasks on both workers; a statement that is not a query runs on the
coordinator, an EXPLAIN ANALYZE on the workers; with no worker a query fails
and nothing runs it locally; the workers' spans come back grafted into the
statement's trace.  The cluster runs with a shared secret: discovery and the
workers refuse a request without its bearer.  Every wait is bounded, and the
workers exit with this process."""

import json
import os
import subprocess
import sys
import time
import urllib.error
import urllib.request

import pytest

from presto1_tpu_torch.client.http_client import Client, QueryFailed
from presto1_tpu_torch.exec.dist_engine import QueryFailed as ClusterFailed
from presto1_tpu_torch.exec.engine import Engine
from presto1_tpu_torch.server.config import (ConfigError, ServerConfig,
                                             build_catalog)
from presto1_tpu_torch.server.security import hash_password, internal_headers
from presto1_tpu_torch.trace import QueryTrace

from perfbench.data.store import Store
from perfbench.drivers.protocol import wire_rows
from perfbench.metrics import _cluster_trace
from perfbench.port_catalog import BenchCatalog
from perfbench.reference.common import judge
from perfbench.traffic import Traffic

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CONFIG = {"name": "tpch-sf1-cluster", "suite": "tpch", "scale_factor": 0.01}
FACTORY = "perfbench.connector:create"
# instance sets: the cell's own (None: the mix's instance_seed) and three
# others
SEEDS = (None, 11, 2 ** 31 + 5, 987654321)
START_TIMEOUT_S = 120.0
SECRET = "cluster-secret"


def mix() -> dict:
    with open(os.path.join(ROOT, "perfbench", "mixes", "streams.json")) as f:
        return json.load(f)


def write_etc(root, name: str, config: dict) -> str:
    etc = os.path.join(str(root), name)
    os.makedirs(os.path.join(etc, "catalog"))
    with open(os.path.join(etc, "config.properties"), "w") as f:
        f.write("".join(f"{k}={v}\n" for k, v in config.items()))
    with open(os.path.join(etc, "catalog", "tpch.properties"), "w") as f:
        f.write(f"connector.name={FACTORY}\n"
                f"bench.config-file={os.path.join(str(root), 'config.json')}"
                "\n")
    return etc


def get(url: str, headers=None):
    """The JSON of ``GET url``, or the HTTP status of its refusal."""
    req = urllib.request.Request(url, headers=headers or {})
    try:
        with urllib.request.urlopen(req, timeout=10) as r:
            return json.load(r)
    except urllib.error.HTTPError as e:
        return e.code


def coordinator(root, **extra):
    cfg = ServerConfig.from_etc_dir(write_etc(
        root, "coordinator", {"coordinator": "true",
                              "node-scheduler.include-coordinator": "false",
                              "http-server.http.port": 0, **extra}))
    cfg.device = "cpu"
    return cfg.build().start()


@pytest.fixture(scope="module")
def cluster(tmp_path_factory):
    root = tmp_path_factory.mktemp("cluster")
    with open(root / "config.json", "w") as f:
        json.dump(CONFIG, f)
    secret = {"internal-communication.shared-secret": SECRET}
    srv = coordinator(root, **secret)
    url = f"http://127.0.0.1:{srv.port}"
    env = {k: v for k, v in os.environ.items()
           if not k.startswith(("JAX_", "XLA_"))}
    env.update(PYTHONPATH=ROOT, OMP_NUM_THREADS="1")
    workers = [subprocess.Popen(
        [sys.executable, "-m", "presto1_tpu_torch.server.launcher",
         "--etc-dir", write_etc(root, f"worker-{k}", {
             "coordinator": "false", "http-server.http.port": 0,
             "discovery.uri": url, **secret}),
         "--device", "cpu", "--parent-pid", str(os.getpid())],
        env=env, cwd=ROOT, stdout=subprocess.DEVNULL,
        stderr=subprocess.DEVNULL, stdin=subprocess.DEVNULL)
        for k in range(2)]
    try:
        deadline = time.monotonic() + START_TIMEOUT_S
        while len(srv.cluster.registry.active_nodes()) < 2:
            assert time.monotonic() < deadline, "workers did not announce"
            assert all(p.poll() is None for p in workers), \
                "a worker exited at start"
            time.sleep(0.1)
        yield srv, url
    finally:
        srv.stop()
        for p in workers:
            p.kill()
            p.wait(timeout=30)


@pytest.fixture(scope="module")
def single():
    """The single-node engine and the reference's tables."""
    store = Store(CONFIG, cache=None)
    return Engine(BenchCatalog(store, device="cpu"), device="cpu"), store


def instances(seed):
    return Traffic(mix(), "tpch", seed or 0, instance_seed=seed).instances


@pytest.mark.parametrize("seed", SEEDS)
def test_queries_answer_as_the_single_node_engine_and_the_reference(
        cluster, single, seed):
    srv, url = cluster
    engine, store = single
    client = Client(url)
    prepared = {}
    for inst in instances(seed):
        module = inst.module
        if inst.name not in prepared:
            prepared[inst.name] = module.prepare(
                {t: {c: store.column(t, c) for c in cols}
                 for t, cols in module.COLUMNS.items()})
        want = module.answer(prepared[inst.name], inst.params)
        columns, rows = client.execute(inst.text)
        got = wire_rows(columns, rows)
        local = engine.sql(inst.text).to_pylist()
        for answer in (got, [list(r) for r in local]):
            ok, err = judge(answer, want, module.OUTPUT, module.ORDER_KEY,
                            module.LIMIT)
            assert ok and err <= 1e-10, (inst.name, inst.params, err)
        assert len(got) == len(local) == len(want)


def test_each_query_runs_as_tasks_on_both_workers(cluster):
    srv, url = cluster
    listed = get(url + "/v1/node", internal_headers(SECRET))
    assert len(listed) == 2
    # every node announces the catalog its properties name by factory
    assert {n["catalog"] for n in listed} == {FACTORY}
    assert isinstance(srv.manager.engine.catalog, BenchCatalog)
    for inst in instances(None)[::4]:
        client = Client(url)
        last = []
        plain = client._request

        def request(method, path, body=None):
            out = plain(method, path, body)
            last[:] = [out]
            return out

        client._request = request
        client.execute(inst.text)
        stats = last[0]["stats"]
        assert stats["state"] == "FINISHED"
        assert set(stats["nodes"]) == {n["nodeId"] for n in listed}
        assert stats["tasks"] == sum(stats["nodes"].values()) >= 2
        assert stats["stages"] >= 1 and stats["coordinator_bytes"] > 0
        if inst.name == "q3":
            assert stats["exchange_bytes"] > 0


def test_other_statements_run_on_the_coordinator(cluster, monkeypatch):
    srv, url = cluster
    calls = []
    plain = srv.cluster.execute_statement
    monkeypatch.setattr(srv.cluster, "execute_statement",
                        lambda *a, **k: calls.append(a) or plain(*a, **k))
    client = Client(url)
    _, rows = client.execute("show tables")
    assert ["lineitem"] in rows
    _, rows = client.execute("explain select count(*) from orders")
    assert rows and not calls
    _, rows = client.execute("  -- a comment\nselect count(*) from nation")
    assert rows == [[25]] and len(calls) == 1


def test_explain_analyze_runs_on_the_workers(cluster, monkeypatch):
    srv, url = cluster
    local = []
    monkeypatch.setattr(srv.manager.engine, "execute_statement",
                        lambda *a, **k: local.append(a))
    monkeypatch.setattr(srv.manager.engine, "explain_analyze",
                        lambda *a, **k: local.append(a))
    monkeypatch.setattr(srv.manager.engine, "sql",
                        lambda *a, **k: local.append(a))
    client = Client(url)
    last = []
    plain = client._request

    def request(method, path, body=None):
        out = plain(method, path, body)
        last[:] = [out]
        return out

    client._request = request
    columns, rows = client.execute(
        "explain analyze select l_returnflag, count(*) from lineitem "
        "group by l_returnflag")
    text = "\n".join(r[0] for r in rows)
    assert [c["name"] for c in columns] == ["plan"]
    assert text.startswith("Stages: ") and "tasks=" in text, text
    assert set(last[0]["stats"]["nodes"]) == {
        n.node_id for n in srv.cluster.registry.all_nodes()}
    assert local == []


def test_the_shared_secret_guards_discovery_and_the_workers(cluster):
    srv, url = cluster
    known = {n.node_id for n in srv.cluster.registry.all_nodes()}
    body = json.dumps({"uri": "http://127.0.0.1:9", "catalog": FACTORY})
    for headers in ({}, {"X-Presto1-Internal-Bearer": "0" * 64},
                    internal_headers("another secret")):
        req = urllib.request.Request(
            url + "/v1/announcement/intruder", data=body.encode(),
            method="PUT", headers=headers)
        with pytest.raises(urllib.error.HTTPError) as e:
            urllib.request.urlopen(req, timeout=10)
        assert e.value.code == 401
        assert get(url + "/v1/node", headers) == 401
    assert {n.node_id for n in srv.cluster.registry.all_nodes()} == known
    listed = get(url + "/v1/node", internal_headers(SECRET))
    assert {n["nodeId"] for n in listed} == known
    for node in srv.cluster.registry.all_nodes():
        # the heartbeat is open, a task is not
        assert get(node.uri + "/v1/status")["nodeId"] == node.node_id
        assert get(node.uri + "/v1/metrics") == 401
        req = urllib.request.Request(
            node.uri + "/v1/task/intruder", method="POST",
            data=b'{"fragment": {}}',
            headers={"Content-Type": "application/json"})
        with pytest.raises(urllib.error.HTTPError) as e:
            urllib.request.urlopen(req, timeout=10)
        assert e.value.code == 401
        assert "metrics" in get(node.uri + "/v1/metrics",
                                internal_headers(SECRET))


def test_an_authenticated_cluster_needs_a_shared_secret(tmp_path):
    with open(tmp_path / "config.json", "w") as f:
        json.dump(CONFIG, f)
    etc = write_etc(tmp_path, "coordinator", {
        "coordinator": "true", "node-scheduler.include-coordinator": "false",
        "http-server.http.port": 0})
    with open(os.path.join(etc, "password.db"), "w") as f:
        f.write(f"alice:{hash_password('pw')}\n")
    with open(os.path.join(etc, "password-authenticator.properties"),
              "w") as f:
        f.write("file.password-file=password.db\n")
    cfg = ServerConfig.from_etc_dir(etc)
    cfg.device = "cpu"
    with pytest.raises(ValueError, match="shared-secret"):
        cfg.build_coordinator()
    with open(os.path.join(etc, "config.properties"), "a") as f:
        f.write(f"internal-communication.shared-secret={SECRET}\n")
    cfg = ServerConfig.from_etc_dir(etc)
    cfg.device = "cpu"
    srv = cfg.build_coordinator()
    assert srv.cluster.internal_secret == SECRET
    srv.httpd.server_close()


def test_no_active_worker_fails_the_query_and_runs_nothing_locally(
        tmp_path, monkeypatch):
    with open(tmp_path / "config.json", "w") as f:
        json.dump(CONFIG, f)
    srv = coordinator(tmp_path)
    try:
        local = []
        monkeypatch.setattr(srv.manager.engine, "execute_statement",
                            lambda *a, **k: local.append(a))
        with pytest.raises(QueryFailed, match="no active worker nodes"):
            Client(f"http://127.0.0.1:{srv.port}").execute(
                "select count(*) from nation")
        with pytest.raises(ClusterFailed, match="no active worker nodes"):
            srv.manager.execute("select 1 from nation", None)
        assert local == []
    finally:
        srv.stop()


def test_worker_spans_are_grafted_into_the_statement_trace(cluster):
    srv, url = cluster
    q3 = next(i for i in instances(None) if i.name == "q3")
    srv.cluster.trace = True
    try:
        out = srv.manager.execute(q3.text, None)
        out.to_pylist()
    finally:
        srv.cluster.trace = False
    trace = out.trace
    spans = trace.spans
    names = [s[0] for s in spans]
    for name in ("statement", "stage_dag", "schedule",
                 "task_create", "gather", "fetch_pages", "pages_decode",
                 "task_wait", "task", "task_fetch", "partition_output",
                 "pages_encode", "execute", "to_host"):
        assert name in names, name
    tasks = [i for i, s in enumerate(spans) if s[0] == "task"]
    assert tasks and set(tasks) <= trace.grafted
    # each task hangs under the schedule span that created it, and names
    # its node and its task
    assert all(spans[spans[i][3]][0] == "schedule" for i in tasks)
    assert len({spans[i][4]["node"] for i in tasks}) == 2
    for s in spans:
        if s[0] == "pages_encode":
            assert s[4]["pages"] >= 1 and s[4]["bytes"] > 0 \
                and s[4]["raw_bytes"] > 0
        if s[0] in ("task_fetch", "fetch_pages"):
            assert s[4]["bytes"] > 0 and s[4]["pages"] >= 1
    # one host, one clock: every span before the batch's read, the
    # workers' too, lies inside the statement
    root = spans[0]
    assert all(root[1] <= s[1] <= s[2] <= root[2]
               for s in spans[:names.index("to_host")])
    own = trace.self_ns()
    assert all(ns >= 0 for ns in own.values()), own
    m = _cluster_trace.statement(trace)["metrics"]
    assert all(v > 0 for v in m.values()), m
    # untraced, nothing is recorded or shipped
    assert getattr(srv.manager.execute(q3.text, None), "trace",
                   None) is None


def test_grafted_roots_are_not_their_parents_time():
    trace = QueryTrace("q")
    i = trace.begin("schedule")
    trace.end(i)
    trace.spans[i][1:3] = [0, 10]
    trace.graft(i, [["task", 5, 105, None, {"node": "a"}],
                    ["op:Scan", 10, 40, 0, 1],
                    ["pages_encode", 50, 70, 0, {}]])
    trace.graft(i, [["task", 6, 56, None, {"node": "b"}]])
    assert trace.grafted == {1, 4}
    assert trace.self_ns() == {"schedule": 10, "task": 50 + 50,
                               "op:Scan": 30, "pages_encode": 20}
    assert [s[3] for s in trace.spans] == [None, 0, 1, 1, 0]
    assert trace.to_dict()["grafted"] == [1, 4]


def test_a_connector_named_by_its_factory(tmp_path):
    with open(tmp_path / "config.json", "w") as f:
        json.dump(CONFIG, f)
    props = {"connector.name": FACTORY,
             "bench.config-file": str(tmp_path / "config.json")}
    cat = build_catalog(props, "tpch", device="cpu")
    assert isinstance(cat, BenchCatalog) and str(cat.device) == "cpu"
    assert cat.table("nation").num_rows == 25
    for bad in ("perfbench.no_such_module:create", "perfbench.connector:nope"):
        with pytest.raises(ConfigError, match="factory"):
            build_catalog({"connector.name": bad}, "tpch", device="cpu")


def test_a_coordinator_executes_unless_configured_not_to(tmp_path):
    with open(tmp_path / "config.json", "w") as f:
        json.dump(CONFIG, f)
    etc = write_etc(tmp_path, "single", {"coordinator": "true"})
    cfg = ServerConfig.from_etc_dir(etc)
    assert cfg.include_coordinator is True
    cfg.device = "cpu"
    srv = cfg.build_coordinator()
    assert srv.cluster is None and srv.manager.cluster is None
    srv.httpd.server_close()
    with open(os.path.join(etc, "config.properties"), "a") as f:
        f.write("node-scheduler.include-coordinator=nope\n")
    with pytest.raises(ConfigError):
        ServerConfig.from_etc_dir(etc)
