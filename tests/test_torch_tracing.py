"""Per-statement traces in the port (``trace.py`` ``QueryTrace``) on the CPU
at SF 0.01, through a compiled TPC-H Q6 and an eager Q3: the span tree, self
times, the waits and their bytes, answers with tracing on and off, nothing
traced when it is off, and the trace written by ``jsonl_listener``.  Also
each statement's own id (events, trace, memory context), the bounded query
history and the metrics registry."""

import ast
import json

import pytest
import torch

import presto1_tpu_torch.trace as tracing
from presto1_tpu_torch.exec.catalog import TpchCatalog
from presto1_tpu_torch.exec.engine import Engine
from presto1_tpu_torch.exec.events import QueryEvent, jsonl_listener
from presto1_tpu_torch.exec.memory import MemoryPool
from presto1_tpu_torch.exec.metrics import CounterStat, MetricsRegistry
from presto1_tpu_torch.exec.session import Session
from presto1_tpu_torch.exec.system_catalog import QueryHistory
from presto1_tpu_torch.tpch.queries import QUERIES

torch.set_num_threads(1)

# (query, compile_queries)
CASES = {"q6_compiled": (6, True), "q3_eager": (3, False)}
# the span that may hold each span (op:* under any of OPERATOR_PARENTS)
PARENTS = {"statement": {None}, "to_host": {None},
           "compile": {"statement"},
           "parse": {"statement", "compile"},
           "plan": {"statement", "compile"},
           "optimize": {"statement", "compile"},
           "run": {"statement"}, "fragment": {"run"},
           "execute": {"statement"}}
OPERATOR_PARENTS = ("fragment", "execute", "compile", "op:")


@pytest.fixture(scope="module")
def catalog():
    return TpchCatalog(sf=0.01, device="cpu")


def _engine(catalog, compiled, **kw):
    session = Session()
    session.set("compile_queries", compiled)
    return Engine(catalog, session=session, device="cpu", **kw)


def _traced(catalog, case, **kw):
    """A traced engine that has answered the case once (its plan cache
    warm), the statement's batch, its rows and its events."""
    q, compiled = CASES[case]
    engine = _engine(catalog, compiled, trace=True, **kw)
    engine.sql(QUERIES[q]).to_pylist()
    events = []
    engine.events.register(events.append)
    out = engine.sql(QUERIES[q])
    return engine, out, out.to_pylist(), events


def _arrays(batch) -> int:
    """Host copies ``to_pylist`` makes: one per array of each column."""
    if batch.num_rows == 0:
        return 0
    return sum(1 + sum(getattr(c, part) is not None
                       for part in ("validity", "lengths", "map_values"))
               for c in batch.columns.values())


def _array_bytes(batch) -> int:
    """Bytes of the host copies ``to_pylist`` makes."""
    n = batch.num_rows
    return sum(getattr(c, part)[:n].numel()
               * getattr(c, part).element_size()
               for c in batch.columns.values()
               for part in ("data", "validity", "lengths", "map_values")
               if getattr(c, part) is not None) if n else 0


def _check_tree(trace):
    spans = trace.spans
    assert [s[0] for s in spans if s[3] is None] == ["statement", "to_host"]
    for i, (name, start, end, parent, _) in enumerate(spans):
        assert start <= end, name
        if parent is None:
            assert name in ("statement", "to_host")
            continue
        assert parent < i
        up = spans[parent]
        assert up[1] <= start and end <= up[2], (name, up[0])
        if name.startswith("op:"):
            assert up[0].startswith(OPERATOR_PARENTS), (name, up[0])
        elif name != "wait":
            assert up[0] in PARENTS[name], (name, up[0])
    # a span begins after its earlier siblings have ended
    for i, a in enumerate(spans):
        for b in spans[i + 1:]:
            if b[3] == a[3]:
                assert b[1] >= a[2], (a[0], b[0])


@pytest.mark.parametrize("case", list(CASES))
def test_span_tree_ids_and_self_times(catalog, case):
    engine, out, _, events = _traced(catalog, case)
    trace = out.trace
    _check_tree(trace)
    names = {s[0] for s in trace.spans}
    q, compiled = CASES[case]
    if compiled:
        assert {"run", "fragment", "wait", "to_host"} <= names
        # the plan cache is warm: no compile, one span per stage
        assert not names & {"compile", "parse", "plan", "optimize",
                            "execute"}
        stages = engine._compiled_cache[QUERIES[q]]._stages
        assert sum(s[0] == "fragment" for s in trace.spans) == len(stages)
        assert [s[4] for s in trace.spans if s[0] == "fragment"] == [
            "/".join(map(str, root)) for root, _, _ in stages]
    else:
        assert {"parse", "plan", "optimize", "execute", "op:Join",
                "wait"} <= names
        assert "run" not in names
    # the statement's own id, on its events, its trace and its batch
    assert [e.kind for e in events] == ["created", "completed"]
    assert {e.query_id for e in events} == {trace.query_id}
    assert events[-1].trace is trace
    assert trace.query_id.startswith(engine.session.query_id + ".")
    again = engine.sql(QUERIES[q])
    assert again.trace.query_id != trace.query_id
    # self times add up to the roots
    roots = sum(s[2] - s[1] for s in trace.spans if s[3] is None)
    assert sum(trace.self_ns().values()) == roots
    assert all(v >= 0 for v in trace.self_ns().values())


@pytest.mark.parametrize("case", list(CASES))
def test_waits_are_counted_by_site(catalog, case):
    _, out, rows, _ = _traced(catalog, case)
    trace = out.trace
    waits = [s for s in trace.spans if s[0] == "wait"]
    in_to_host = [s for s in waits
                  if trace.spans[s[3]][0] == "to_host"]
    assert len(in_to_host) == _arrays(out) and rows
    if CASES[case][1]:
        # one readback ends a compiled run
        assert len(waits) == 1 + _arrays(out)
    else:
        # the eager executor reads row counts back as it goes
        assert len(waits) > 1 + _arrays(out)


@pytest.mark.parametrize("case", list(CASES))
def test_waits_carry_the_bytes_they_copy(catalog, case):
    _, out, _, _ = _traced(catalog, case)
    trace = out.trace
    waits = [s for s in trace.spans if s[0] == "wait"]
    copies = [s[4] for s in waits if trace.spans[s[3]][0] == "to_host"]
    assert sum(copies) == _array_bytes(out) > 0
    assert all(isinstance(s[4], int) and s[4] >= 0 for s in waits)
    if CASES[case][1]:
        # the readback: the row count and the overflow flag, or the stream
        # synchronize, which copies nothing
        assert waits[0][4] in (0, 16)


def test_the_trace_module_imports_nothing_of_the_package():
    # the data, operator and executor layers all record into it
    tree = ast.parse(open(tracing.__file__).read())
    imported = {a.name.split(".")[0] for n in ast.walk(tree)
                if isinstance(n, ast.Import) for a in n.names}
    imported |= {n.module.split(".")[0] for n in ast.walk(tree)
                 if isinstance(n, ast.ImportFrom) and n.level == 0}
    assert not any(isinstance(n, ast.ImportFrom) and n.level
                   for n in ast.walk(tree))
    assert imported <= {"__future__", "time", "contextvars", "typing",
                        "torch"}


@pytest.mark.parametrize("case", list(CASES))
def test_answers_equal_and_nothing_traced_when_off(catalog, case,
                                                   monkeypatch):
    q, compiled = CASES[case]
    _, _, traced_rows, _ = _traced(catalog, case)
    calls = []
    clock = tracing.clock_ns

    def counting():
        calls.append(1)
        return clock()

    monkeypatch.setattr(tracing, "clock_ns", counting)
    engine = _engine(catalog, compiled)
    engine.sql(QUERIES[q]).to_pylist()
    seen = []
    engine.events.register(seen.append)
    out = engine.sql(QUERIES[q])
    rows = out.to_pylist()
    assert rows == traced_rows
    assert out.trace is None and seen[-1].trace is None
    assert tracing.TRACE.get() is None and calls == []
    engine.trace = True
    engine.sql(QUERIES[q]).to_pylist()
    assert calls


def test_failed_statement_carries_its_trace(catalog):
    engine = _engine(catalog, False, trace=True)
    seen = []
    engine.events.register(seen.append)
    with pytest.raises(Exception):
        engine.sql("select no_such_column from nation")
    assert seen[-1].kind == "failed"
    trace = seen[-1].trace
    assert trace.spans[0][0] == "statement" and trace.spans[0][2] is not None
    assert all(s[2] is not None for s in trace.spans)
    assert tracing.TRACE.get() is None


def test_jsonl_listener_writes_a_trace_that_reads_back(catalog, tmp_path):
    path = tmp_path / "traces.jsonl"
    engine = _engine(catalog, True, trace=True)
    engine.events.register(jsonl_listener(str(path)))
    out = engine.sql(QUERIES[6])
    written = out.trace.to_dict()  # before to_pylist adds to_host
    out.to_pylist()
    rows = [json.loads(line) for line in path.read_text().splitlines()]
    assert [r["kind"] for r in rows] == ["created", "completed"]
    assert rows[0]["trace"] is None
    assert rows[1]["trace"] == written
    assert rows[1]["query_id"] == written["query_id"] == out.trace.query_id
    assert [s["name"] for s in written["spans"]][0] == "statement"
    assert "to_host" not in {s["name"] for s in written["spans"]}


def test_each_statement_has_its_own_memory_context(catalog, monkeypatch):
    ids = []
    plain = MemoryPool.register

    def register(self, ctx):
        ids.append(ctx.query_id)
        return plain(self, ctx)

    monkeypatch.setattr(MemoryPool, "register", register)
    engine = _engine(catalog, False, memory_pool=MemoryPool(1 << 40))
    seen = []
    engine.events.register(seen.append)
    for _ in range(2):
        engine.sql("select count(*) from nation").to_pylist()
    assert len(ids) == 2 and ids[0] != ids[1]
    assert ids == [e.query_id for e in seen if e.kind == "created"]


def test_query_history_forgets_what_leaves_it():
    history = QueryHistory(limit=3)
    for i in range(5):
        for kind in ("created", "completed"):
            history(QueryEvent(kind, f"s.{i}", "select 1", "u"))
    assert [e["query_id"] for e in history.entries] == ["s.2", "s.3", "s.4"]
    assert sorted(history.by_id) == ["s.2", "s.3", "s.4"]
    assert all(e["state"] == "FINISHED" for e in history.entries)
    # one id created again (a session's id, as before) keeps one entry
    history(QueryEvent("created", "s.4", "select 2", "u"))
    assert sorted(history.by_id) == ["s.3", "s.4"]
    assert history.by_id["s.4"] is history.entries[-1]


def test_counter_ring_and_registry(monkeypatch):
    import presto1_tpu_torch.exec.metrics as metrics

    now = [1000.0]
    monkeypatch.setattr(metrics.time, "time", lambda: now[0])
    c = CounterStat()
    for _ in range(5):
        c.update(2)
    now[0] += 61.0
    c.update(1)
    assert c.total == 11 and c.one_minute_count() == 1
    assert len(c._events) == 1
    registry = MetricsRegistry()
    assert registry.counter("a") is registry.counter("a")
    assert registry.distribution("d") is registry.distribution("d")
    registry.counter("a").update(3)
    assert [r["name"] for r in registry.snapshot()] == ["a", "d"]
