"""External fragment inputs and the worker's routes, on the CPU.

* ``CompiledQuery(catalog, plan, stubs=)`` / ``cq(stubs=)``: on every stage
  of TPC-H Q3, Q1 and a broadcast join cut by ``build_stage_dag`` (the
  fragments a worker runs, with their remote sources as stubs), the
  compiled fragment equals the port's eager ``Executor(stubs=)`` and the
  JAX package's eager ``Executor(stubs=)`` on the same stage plan.  A later
  call with more rows than discovery saw raises ``ExecError`` (by the
  capacity check, or by the guards at the readback); it never truncates.
* The worker's routes (``WorkerRuntime._compute`` / ``_run``): a tripped
  guard discovers again and is counted; any other failure of the compiled
  route fails the task and runs nothing eagerly; a nested remote input
  takes the eager route, counted and reported.
* The worker half of ``tests/test_arrays.py::
  test_nested_pages_partition_and_paginate`` (ROADMAP A11 left it for the
  server plane), held against the JAX package's worker.
* The TPC-H disk cache under two processes at once, and the shard reads
  from it.
"""

import hashlib
import json
import os
import subprocess
import sys
import time

import numpy as np
import pytest
import torch

import presto1_tpu.exec.catalog as j_catalog
import presto1_tpu.exec.engine as j_engine
import presto1_tpu.exec.executor as j_executor
import presto1_tpu.exec.stage_dag as j_dag
import presto1_tpu_torch.exec.catalog as t_catalog
import presto1_tpu_torch.exec.engine as t_engine
import presto1_tpu_torch.exec.executor as t_executor
import presto1_tpu_torch.exec.stage_dag as t_dag
from presto1_tpu_torch.batch import RecordBatch
from presto1_tpu_torch.exec.metrics import REGISTRY
from presto1_tpu_torch.sql.serde import plan_to_json
from presto1_tpu_torch.tpch.queries import QUERIES

from test_tpch import assert_frames_match

torch.set_num_threads(1)

_T_CAT = t_catalog.TpchCatalog("tiny", device="cpu")
_J_CAT = j_catalog.TpchCatalog("tiny")

BROADCAST_JOIN = ("select n_name, count(*) c, sum(s_acctbal) b "
                  "from supplier, nation where s_nationkey = n_nationkey "
                  "group by n_name order by n_name")


def _stage_outputs(plan, cat, executor, dag, broadcast):
    """Every stage of ``plan``'s DAG run eagerly by ``executor`` (a class)
    with its remote sources as stubs: {sid: (stage, stubs, output)}."""
    _, _, stages = dag.build_stage_dag(plan, cat,
                                       broadcast_threshold=broadcast)
    outs = {}
    for st in stages:
        stubs = {s.stub_path: outs[s.stage][2] for s in st.sources}
        kw = {"device": "cpu"} if executor is t_executor.Executor else {}
        outs[st.sid] = (st, stubs,
                        executor(cat, stubs=stubs, **kw).execute(st.plan))
    return outs


CASES = [("q3", QUERIES[3], 0), ("q1", QUERIES[1], 0),
         ("q3_broadcast", QUERIES[3], 100_000),
         ("broadcast_join", BROADCAST_JOIN, 100_000)]


@pytest.fixture(scope="module", params=CASES, ids=[c[0] for c in CASES])
def stage_runs(request):
    _, sql, broadcast = request.param
    port = _stage_outputs(t_engine.Engine(_T_CAT, device="cpu").plan(sql),
                          _T_CAT, t_executor.Executor, t_dag, broadcast)
    ref = _stage_outputs(j_engine.Engine(_J_CAT).plan(sql), _J_CAT,
                         j_executor.Executor, j_dag, broadcast)
    return port, ref


def test_compiled_fragment_equals_eager_and_reference(stage_runs):
    port, ref = stage_runs
    assert sorted(port) == sorted(ref)
    with_sources = 0
    for sid, (st, stubs, eager) in port.items():
        want = ref[sid][2].to_pandas()
        assert_frames_match(eager.to_pandas(), want, ordered=False)
        if not stubs:
            continue
        with_sources += 1
        cq = t_executor.CompiledQuery(_T_CAT, st.plan, stubs=stubs,
                                      device="cpu")
        assert cq.guard_ranges
        got = cq(stubs=stubs)
        assert got.to_pylist() == eager.to_pylist()
        assert_frames_match(got.to_pandas(), want, ordered=False)
        # a second call reuses the program on the same inputs
        assert cq(stubs=stubs).to_pylist() == eager.to_pylist()
        assert cq.block_run(reps=2, stubs=stubs) == eager.num_rows
    assert with_sources >= 1


def _prefix(batch: RecordBatch, n: int) -> RecordBatch:
    """The first ``n`` rows of ``batch`` at its capacity."""
    return RecordBatch(batch.columns, n)


def test_more_rows_than_discovery_rediscovers_never_truncates():
    """Discovery on a stub holding half of a join stage's input rows; a
    call with all of them at the same capacity trips the guards at the
    readback, and one beyond the capacity is refused before it runs.  A
    program discovered on the larger input answers what the eager
    executor answers."""
    plan = t_engine.Engine(_T_CAT, device="cpu").plan(QUERIES[3])
    port = _stage_outputs(plan, _T_CAT, t_executor.Executor, t_dag, 0)
    st, stubs, eager = next(v for v in port.values()
                            if v[0].distribution == "hash" and v[1])
    half = {p: _prefix(b, int(b.num_rows) // 2) for p, b in stubs.items()}
    cq = t_executor.CompiledQuery(_T_CAT, st.plan, stubs=half, device="cpu")
    small = t_executor.Executor(_T_CAT, stubs=half,
                                device="cpu").execute(st.plan)
    assert cq(stubs=half).to_pylist() == small.to_pylist()
    with pytest.raises(t_executor.ExecError):
        cq(stubs=stubs)
    bigger = {p: RecordBatch(
        {n: c.with_data(torch.cat([c.data, c.data]),
                        None if c.validity is None
                        else torch.cat([c.validity, c.validity]))
         for n, c in b.columns.items()}, b.num_rows)
        for p, b in stubs.items()}
    with pytest.raises(t_executor.ExecError, match="capacity"):
        cq(stubs=bigger)
    again = t_executor.CompiledQuery(_T_CAT, st.plan, stubs=stubs,
                                     device="cpu")
    assert again(stubs=stubs).to_pylist() == eager.to_pylist()


def test_stub_with_other_dictionary_is_refused():
    """A call whose varchar stub carries another dictionary than discovery
    saw raises (a compiled program folds string comparisons against the
    discovery dictionaries)."""
    from dataclasses import replace

    plan = t_engine.Engine(_T_CAT, device="cpu").plan(BROADCAST_JOIN)
    port = _stage_outputs(plan, _T_CAT, t_executor.Executor, t_dag, 0)
    st, stubs, _ = next(v for v in port.values()
                        if v[1] and any(c.dictionary is not None
                                        for b in v[1].values()
                                        for c in b.columns.values()))
    cq = t_executor.CompiledQuery(_T_CAT, st.plan, stubs=stubs, device="cpu")
    other = {}
    for p, b in stubs.items():
        cols = {n: (replace(c, dictionary=np.array(
                    [s + "x" for s in c.dictionary]))
                    if c.dictionary is not None else c)
                for n, c in b.columns.items()}
        other[p] = RecordBatch(cols, b.num_rows)
    with pytest.raises(t_executor.ExecError, match="dictionary"):
        cq(stubs=other)


# ------------------------------------------------------------ worker routes


def _counter(name):
    return REGISTRY.counter(name).total


@pytest.fixture
def runtime(monkeypatch):
    from presto1_tpu_torch.server.worker import WorkerRuntime

    monkeypatch.setenv("P1_WORKER_COMPILE", "always")
    rt = WorkerRuntime("tpch:tiny", device="cpu")
    yield rt
    rt.task_executor.stop()


def _join_stage():
    plan = t_engine.Engine(_T_CAT, device="cpu").plan(QUERIES[3])
    port = _stage_outputs(plan, _T_CAT, t_executor.Executor, t_dag, 0)
    return next(v for v in port.values()
                if v[0].distribution == "hash" and v[1])


def test_worker_rediscovers_when_a_guard_trips(runtime):
    from presto1_tpu_torch.server.worker import WorkerTask

    st, stubs, eager = _join_stage()
    body = {"fragment": plan_to_json(st.plan), "query": "q"}
    half = {p: _prefix(b, int(b.num_rows) // 2) for p, b in stubs.items()}
    before = {k: _counter(f"worker.{k}") for k in
              ("fragments_rediscovered", "compiled_task_runs",
               "eager_fragments")}
    t1 = WorkerTask("t1")
    out, qstats = runtime._compute(t1, body, st.plan,
                                   runtime.base_catalog(), None, half)
    assert qstats is None and t1.route == "compiled"
    t2 = WorkerTask("t2")  # same signature (capacity), more rows
    out, qstats = runtime._compute(t2, body, st.plan,
                                   runtime.base_catalog(), None, stubs)
    assert qstats is None and t2.route == "rediscovered"
    assert out.to_pylist() == eager.to_pylist()
    assert _counter("worker.fragments_rediscovered") == \
        before["fragments_rediscovered"] + 1
    assert _counter("worker.compiled_task_runs") == \
        before["compiled_task_runs"] + 2
    assert _counter("worker.eager_fragments") == before["eager_fragments"]


def _wait(task, timeout_s=60.0):
    assert task.done.wait(timeout_s), "task did not finish in time"


def test_a_compiled_failure_fails_the_task_and_runs_nothing_eagerly(
        runtime, monkeypatch):
    """Any failure of the compiled route other than a tripped guard fails
    the task through its status: no eager run follows it (the JAX
    package's ``_try_compiled`` prints it and runs the fragment eagerly,
    ``presto1_tpu/server/worker.py:567-587``)."""
    plan = t_engine.Engine(_T_CAT, device="cpu").plan(QUERIES[6])
    calls = {"eager": 0}
    real_execute = t_executor.Executor.execute

    def counting_execute(self, node, path=()):
        if path == () and self.stats is not None:
            calls["eager"] += 1
        return real_execute(self, node, path)

    def broken_call(self, stubs=None):
        raise RuntimeError("device fault in a compiled fragment")

    monkeypatch.setattr(t_executor.Executor, "execute", counting_execute)
    monkeypatch.setattr(t_executor.CompiledQuery, "__call__", broken_call)
    failed = _counter("worker.tasks_failed")
    eager = _counter("worker.eager_fragments")
    task = runtime.create_task("broken", {
        "fragment": plan_to_json(plan), "shard": {"index": 0, "count": 2},
        "query": "q"})
    _wait(task)
    assert task.state == "FAILED"
    assert "device fault in a compiled fragment" in task.error
    assert task.route is None and calls["eager"] == 0
    assert _counter("worker.tasks_failed") == failed + 1
    assert _counter("worker.eager_fragments") == eager


def test_a_failing_discovery_fails_the_task(runtime, monkeypatch):
    plan = t_engine.Engine(_T_CAT, device="cpu").plan(QUERIES[6])

    def broken_init(self, *a, **kw):
        raise ValueError("discovery failed")

    monkeypatch.setattr(t_executor.CompiledQuery, "__init__", broken_init)
    eager = _counter("worker.eager_fragments")
    task = runtime.create_task("broken-discovery", {
        "fragment": plan_to_json(plan), "shard": {"index": 1, "count": 2}})
    _wait(task)
    assert task.state == "FAILED" and "discovery failed" in task.error
    assert _counter("worker.eager_fragments") == eager


def test_task_routes_are_reported(runtime):
    """A source task runs compiled ('always'), one asking for statistics
    runs eagerly and says why; both answer Q6's shard partial."""
    plan = t_engine.Engine(_T_CAT, device="cpu").plan(QUERIES[6])
    shard = {"index": 0, "count": 1}
    a = runtime.create_task("compiled", {"fragment": plan_to_json(plan),
                                         "shard": shard})
    b = runtime.create_task("stats", {"fragment": plan_to_json(plan),
                                      "shard": shard, "collect_stats": True})
    _wait(a)
    _wait(b)
    assert (a.state, a.route) == ("FINISHED", "compiled")
    assert (b.state, b.route) == ("FINISHED", "eager:stats")
    assert a.info()["route"] == "compiled"
    assert a.buffers == b.buffers
    assert b.operator_stats and a.operator_stats[0]["name"] == \
        "CompiledFragment"


def test_nested_remote_input_takes_the_counted_eager_route(runtime):
    from presto1_tpu_torch.server.worker import WorkerTask

    sql = ("select n_name, sum(cardinality(a)) c "
           "from (select s_nationkey k, array[s_suppkey, s_nationkey] a "
           "      from supplier) t join nation on k = n_nationkey "
           "group by n_name order by n_name")
    plan = t_engine.Engine(_T_CAT, device="cpu").plan(sql)
    port = _stage_outputs(plan, _T_CAT, t_executor.Executor, t_dag, 0)
    st, stubs, eager = next(
        v for v in port.values() if v[1] and any(
            c.is_nested for b in v[1].values() for c in b.columns.values()))
    before = _counter("worker.eager_fragments")
    task = WorkerTask("nested")
    out, qstats = runtime._compute(task, {"fragment": plan_to_json(st.plan)},
                                   st.plan, runtime.base_catalog(), None,
                                   stubs)
    assert task.route == "eager:nested-input" and qstats is not None
    assert out.to_pylist() == eager.to_pylist()
    assert _counter("worker.eager_fragments") == before + 1


# -------------------------------------------------- nested pages (A11 half)


def test_nested_pages_partition_and_paginate(monkeypatch):
    """Array columns through the worker's partition / paginate and the
    pages' concat, as ``tests/test_arrays.py`` drives the JAX package's:
    lengths stay aligned with their rows, each row's elements stay with the
    row, and the buffers hold the JAX package's rows."""
    import jax.numpy as jnp

    from presto1_tpu.batch import Column as JColumn, RecordBatch as JBatch
    from presto1_tpu.server import worker as JW
    from presto1_tpu.types import BIGINT as JBIGINT
    from presto1_tpu.types import parse_type_str as j_type
    from presto1_tpu_torch.batch import Column
    from presto1_tpu_torch.exec import pages as P
    from presto1_tpu_torch.server import worker as W
    from presto1_tpu_torch.types import BIGINT, parse_type_str

    at = parse_type_str("array(bigint)")
    n = 25
    data = np.arange(n * 3, dtype=np.int64).reshape(n, 3)
    lengths = (np.arange(n) % 4).astype(np.int32)
    k = np.arange(n, dtype=np.int64)
    b = RecordBatch({
        "k": Column(torch.from_numpy(k), BIGINT),
        "a": Column(torch.from_numpy(data), at,
                    lengths=torch.from_numpy(lengths)),
    }, n)
    jb = JBatch({"k": JColumn(jnp.asarray(k), JBIGINT),
                 "a": JColumn(jnp.asarray(data), j_type("array(bigint)"),
                              lengths=jnp.asarray(lengths))}, n)

    monkeypatch.setattr(W, "PAGE_MAX_ROWS", 10)
    pgs = W._paginate(b, 0, n)
    assert len(pgs) == 3
    rts = [P.deserialize_batch(p) for p in pgs]
    got_lengths = np.concatenate(
        [r["a"].lengths.numpy()[:r.num_rows] for r in rts])
    assert list(got_lengths) == list(lengths)
    row0 = rts[2]["a"].data[0, :int(rts[2]["a"].lengths[0])]
    assert row0.tolist() == list(data[20, :lengths[20]])

    bufs = W._partition_output(b, n, ["k"], 3)
    seen = {}
    for buf in bufs:
        for p in buf:
            r = P.deserialize_batch(p)
            for i in range(r.num_rows):
                ln = int(r["a"].lengths[i])
                seen[int(r["k"].data[i])] = r["a"].data[i][:ln].tolist()
    assert len(seen) == n
    for key in range(n):
        assert seen[key] == list(data[key, :lengths[key]])

    def rows(buffers):
        out = []
        for buf in buffers:
            part = []
            for p in buf:
                r = P.deserialize_batch(p)
                part += [(int(r["k"].data[i]),
                          r["a"].data[i][:int(r["a"].lengths[i])].tolist())
                         for i in range(r.num_rows)]
            out.append(part)
        return out

    assert rows(bufs) == rows(JW._partition_output(jb, n, ["k"], 3))

    b2 = RecordBatch({
        "k": Column(torch.tensor([100, 101]), BIGINT),
        "a": Column(torch.tensor([[7, 8, 9, 10, 11], [1, 2, 3, 4, 5]]), at,
                    lengths=torch.tensor([5, 2], dtype=torch.int32)),
    }, 2)
    h1 = P.deserialize_batch(P.serialize_batch(b))
    h2 = P.deserialize_batch(P.serialize_batch(b2))
    merged = P.concat_batches([h1, h2])
    assert merged.num_rows == n + 2
    assert merged["a"].lengths[-2:].tolist() == [5, 2]
    assert merged["a"].data[n][:5].tolist() == [7, 8, 9, 10, 11]
    dev = P.concat_batches([h1, h2], device="cpu")
    assert dev["a"].lengths is not None
    assert dev["a"].lengths[:n + 2].tolist() == merged["a"].lengths.tolist()


# ------------------------------------------------------- the TPC-H cache

_FILL = r"""
import hashlib, json, sys
import numpy as np
from presto1_tpu_torch.exec.catalog import TpchCatalog
cat = TpchCatalog(sf=0.001, cache_dir=sys.argv[1], device="cpu")
out = {}
for t in ("lineitem", "orders", "customer", "nation"):
    for c in cat.table(t).schema:
        col = cat.table(t).host_column(c)
        h = hashlib.sha256(np.ascontiguousarray(col.data).tobytes())
        if col.dictionary is not None:
            h.update("\x00".join(map(str, col.dictionary)).encode())
        out[f"{t}.{c}"] = h.hexdigest()
print(json.dumps(out))
"""


def _digests(cat):
    out = {}
    for t in ("lineitem", "orders", "customer", "nation"):
        for c in cat.table(t).schema:
            col = cat.table(t).host_column(c)
            h = hashlib.sha256(np.ascontiguousarray(col.data).tobytes())
            if col.dictionary is not None:
                h.update("\x00".join(map(str, col.dictionary)).encode())
            out[f"{t}.{c}"] = h.hexdigest()
    return out


def test_two_processes_fill_one_cache_at_once(tmp_path):
    """Two processes generate and write one TPC-H cache at the same time
    and both read back equal columns, equal to columns made without a
    cache; a third reads them from the cache; no temporary file is left."""
    cache = str(tmp_path / "cache")
    env = {k: v for k, v in os.environ.items() if not k.startswith("JAX_")}
    env["PYTHONPATH"] = os.path.dirname(os.path.dirname(
        os.path.abspath(__file__)))
    env["OMP_NUM_THREADS"] = "1"
    procs = [subprocess.Popen([sys.executable, "-c", _FILL, cache],
                              stdout=subprocess.PIPE,
                              stderr=subprocess.PIPE, env=env, text=True)
             for _ in range(2)]
    outs = []
    for p in procs:
        out, err = p.communicate(timeout=300)
        assert p.returncode == 0, err[-2000:]
        outs.append(json.loads(out))
    want = _digests(t_catalog.TpchCatalog(sf=0.001, device="cpu"))
    assert outs[0] == outs[1] == want
    cached = t_catalog.TpchCatalog(sf=0.001, cache_dir=cache, device="cpu")
    assert _digests(cached) == want
    left = [f for _, _, fs in os.walk(cache) for f in fs
            if f.endswith(".tmp")]
    assert left == []


def test_a_failed_cache_write_leaves_no_file(tmp_path, monkeypatch):
    from presto1_tpu_torch.exec import catalog as C

    target = str(tmp_path / "x.npy")

    def broken_save(f, arr, allow_pickle=False):
        f.write(b"\x93NUMPY partial")
        raise OSError("disk full")

    monkeypatch.setattr(C.np, "save", broken_save)
    with pytest.raises(OSError):
        C._save_atomic(target, np.arange(10))
    assert os.listdir(tmp_path) == []


def test_shard_reads_only_its_rows_from_the_cache(tmp_path):
    """A shard view of a cached table reads its rows from the file (memory
    mapped): equal to the whole column's slice, and nothing is uploaded to
    the base table."""
    cache = str(tmp_path / "c")
    base = t_catalog.TpchCatalog(sf=0.001, cache_dir=cache, device="cpu")
    whole = {c: base.table("lineitem").host_column(c)
             for c in ("l_orderkey", "l_returnflag")}
    fresh = t_catalog.TpchCatalog(sf=0.001, cache_dir=cache, device="cpu")
    view = t_catalog.ShardedCatalog(fresh, 1, 3)
    t = view.table("lineitem")
    for c, col in whole.items():
        got = t.column(c)
        assert got.data.tolist() == \
            np.asarray(col.data)[t.lo:t.hi].tolist()
        if col.dictionary is not None:
            assert list(got.dictionary) == list(col.dictionary)
    assert not fresh.table("lineitem")._cache


def test_column_cache_uploads_once_under_threads():
    """Twice as many threads as cores ask a fresh table for two columns at
    once, with a short switch interval: one load a column, one shared
    column each."""
    import threading

    cat = t_catalog.TpchCatalog(sf=0.001, device="cpu")
    table = cat.table("orders")
    loads = []
    real = table._load

    def slow_load(name, device):
        loads.append(name)
        time.sleep(0.02)
        return real(name, device)

    table._load = slow_load
    names = ("o_orderkey", "o_totalprice")
    got = {n: [] for n in names}
    n_threads = 2 * (os.cpu_count() or 4)
    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-5)
    try:
        threads = [threading.Thread(target=lambda n=names[i % 2]: got[n]
                                    .append(table.column(n)))
                   for i in range(n_threads)]
        for th in threads:
            th.start()
        for th in threads:
            th.join(60)
    finally:
        sys.setswitchinterval(interval)
    assert not any(th.is_alive() for th in threads)
    assert sorted(loads) == sorted(names)
    for n in names:
        assert len(got[n]) == n_threads // 2
        assert all(g is got[n][0] for g in got[n])
