"""CUDA-graph replay of compiled statements (``CompiledQuery._execute``,
``exec/cuda_graph.py``) at SF 0.01.

On the card: every TPC-H query compiled, its eager warm-up, its capture and
a later replay against the pandas oracle; sampled discovery; a batch that a
later call leaves as it was; the overflow guard through a replay; grouped
execution and a statement with external inputs running eagerly with their
reason; one ``op:GraphReplay`` span and no ``fragment`` span in a replayed
statement's trace.  Run there with ``python3 -m pytest --noconftest -m cuda
tests/test_torch_graph_replay.py`` (this file imports no JAX).

On the CPU: no capture, with the reason recorded; and the same state
machine with a stand-in for the CUDA graph whose replay runs the statement
again into the captured buffers, as a graph's replay rewrites them.
"""

import gc
import threading

import numpy as np
import pytest
import torch

from presto1_tpu_torch.exec import cuda_graph
from presto1_tpu_torch.exec.catalog import TpchCatalog
from presto1_tpu_torch.exec.engine import Engine
from presto1_tpu_torch.exec.executor import (
    CompiledQuery, ExecError, Executor, _node_at,
)
from presto1_tpu_torch.exec.session import Session
from presto1_tpu_torch.expr import eval as expr_eval
from presto1_tpu_torch.testing.verifier import compare_frames
from presto1_tpu_torch.tpch.queries import QUERIES
from presto1_tpu_torch.tpch.schema import TABLES
from presto1_tpu_torch.trace import TRACE

from tpch_oracle import ORACLE

torch.set_num_threads(1)

OVERFLOW_SQL = "select l_orderkey from lineitem where l_quantity < 2"
# a compiled run that looks up two dictionary tables: the array's merged
# dictionary and the literal's codes in it
TABLES_SQL = ("select n_name, contains(array[n_name, r_name], 'ASIA') as c "
              "from nation, region where n_regionkey = r_regionkey")
# the sampled-discovery cases of tests/test_torch_sampled_discovery.py
SAMPLED = [1, 3, 5, 6, 9, 17, 18, 20]
SAMPLE = {"lineitem": 8}


def _engine(device, compiled=False, **kw):
    session = Session()
    session.set("compile_queries", compiled)
    return Engine(TpchCatalog("tiny", device=device), session=session,
                  device=device, **kw)


def _frames(engine):
    return {t: engine.catalog.table(t).batch().to_pandas() for t in TABLES}


def _spans(trace, name):
    return sum(s[0] == name for s in trace.spans)


def _planted_overflow(engine):
    """A statement whose recorded capacities are below its data (as if
    discovery had seen far fewer rows)."""
    cq = engine.compile(OVERFLOW_SQL)
    cq.record[(0, 0)]["capacity"] = 128
    cq._caps[()] = 128
    return cq


def _stubbed(engine, device):
    """Q6 as a compiled fragment whose filter below the aggregate is an
    external input, and that input."""
    plan = engine.plan(QUERIES[6])
    below = Executor(engine.catalog, device=device).execute(
        _node_at(plan, (0, 0)))
    stubs = {(0, 0): below}
    return CompiledQuery(engine.catalog, plan, stubs=stubs,
                         device=device), stubs


def _answers_kept(engine, cq):
    """A batch from a replay keeps its answer when the scan inputs change
    in place and the statement is called again: the later call answers
    the new data, the earlier batch the old."""
    first = cq()
    want = first.to_pylist()
    qty = next(k for k in cq.inputs if k.startswith("l_quantity"))
    cq.inputs[qty].add_(1)
    try:
        moved = cq().to_pylist()
    finally:
        cq.inputs[qty].sub_(1)
    assert cq.graph_reason is None  # both calls replayed
    assert moved != want
    assert first.to_pylist() == want
    assert cq().to_pylist() == want


# ------------------------------------------------------------ on the CPU


@pytest.fixture(scope="module")
def cpu():
    return _engine("cpu")


def test_cpu_statement_never_captures_and_says_why(cpu):
    cq = cpu.compile(QUERIES[3])
    for _ in range(3):
        cq()
    assert cq.graph_state == "eager" and cq._graph is None
    assert "the device is cpu" in cq.graph_reason
    assert cq.block_run(reps=2) == cq().num_rows


def test_stubbed_statement_says_it_has_external_inputs(cpu):
    cq, stubs = _stubbed(cpu, "cpu")
    got = [cq(stubs=stubs).to_pylist() for _ in range(3)]
    assert cq.graph_state == "eager"
    assert "external inputs" in cq.graph_reason
    assert got == [cpu.sql(QUERIES[6]).to_pylist()] * 3


def test_cpu_replaced_inputs_say_so(cpu):
    cq = cpu.compile(QUERIES[6])
    want = cq().to_pylist()
    cq.inputs = dict(cq.inputs)
    assert cq().to_pylist() == want
    assert "scan inputs" in cq.graph_reason and cq._graph is None


class _Graph:
    """Stands for ``torch.cuda.CUDAGraph`` on the CPU: a replay runs the
    captured statement again, untraced, and writes its outputs into the
    buffer the capture packed them in."""

    def __init__(self, run, pack, device):
        self.run, self.pack, self.device = run, pack, device
        self.replays = 0

    def replay(self):
        token = TRACE.set(None)
        try:
            data, validity, pair = self.run()
        finally:
            TRACE.reset(token)
        self.pack.copy_(cuda_graph._pack(data, validity, pair,
                                         self.device)[0])
        self.replays += 1


def _capture_on_cpu(cls, run, device):
    data, validity, pair = run()
    pack, layout, at = cuda_graph._pack(data, validity, pair, device)
    return cls(_Graph(run, pack, device), pack, layout,
               pair if at is None else (at,), threading.Lock())


@pytest.fixture
def stand_in(monkeypatch):
    """Captures made with ``_Graph``; ``as_if_cuda(cq)`` lets a CPU
    statement capture."""
    monkeypatch.setattr(cuda_graph.StatementGraph, "capture",
                        classmethod(_capture_on_cpu))

    def as_if_cuda(cq):
        cq._graph_never = None
        cq.graph_state = "pending"
        return cq

    return as_if_cuda


@pytest.fixture(scope="module")
def cpu_frames(cpu):
    return _frames(cpu)


@pytest.mark.parametrize("qid", [1, 3, 6, 7, 18])
def test_stand_in_replay_matches_eager_and_oracle(cpu, cpu_frames,
                                                  stand_in, qid):
    cq = stand_in(cpu.compile(QUERIES[qid]))
    eager = cq().to_pandas()
    assert cq.graph_state == "pending" and "warm-up" in cq.graph_reason
    assert cq._warmed
    runs = [cq().to_pandas() for _ in range(2)]
    assert cq.graph_state == "captured" and cq.graph_reason is None
    assert cq._graph.graph.replays == 2
    for got in [eager] + runs:
        assert compare_frames(got, ORACLE[qid](cpu_frames)) is None
    assert cq.block_run(reps=3) == len(eager)
    assert cq._graph.graph.replays == 5


def test_stand_in_batches_are_copies(cpu, stand_in):
    cq = stand_in(cpu.compile(
        "select sum(l_quantity) as q, count(*) as n from lineitem "
        "where l_shipdate < date '1995-01-01'"))
    cq()
    _answers_kept(cpu, cq)
    batch = cq()
    pack = cq._graph.pack
    for c in batch.columns.values():
        assert c.data.untyped_storage().data_ptr() != \
            pack.untyped_storage().data_ptr()


def test_stand_in_overflow_raises_through_a_replay(cpu, stand_in):
    cq = stand_in(_planted_overflow(cpu))
    for _ in range(3):
        with pytest.raises(ExecError, match="overflow"):
            cq()
    assert cq.graph_state == "captured" and cq.graph_reason is None
    with pytest.raises(ExecError, match="overflow"):
        cq.block_run(reps=2)


def test_stand_in_replaced_inputs_run_eagerly(cpu, stand_in):
    cq = stand_in(cpu.compile(QUERIES[6]))
    want = [cq().to_pylist(), cq().to_pylist()]
    assert cq.graph_state == "captured"
    cq.inputs = dict(cq.inputs)
    assert cq().to_pylist() == want[0] == want[1]
    assert "scan inputs" in cq.graph_reason
    assert cq._graph.graph.replays == 1


def test_stand_in_busy_graph_runs_eagerly(cpu, stand_in):
    cq = stand_in(cpu.compile(QUERIES[6]))
    want = cq().to_pylist()
    cq()
    with cq._graph_lock:  # another thread is replaying
        assert cq().to_pylist() == want
        assert "another thread" in cq.graph_reason
    assert cq().to_pylist() == want and cq.graph_reason is None


def test_stand_in_threads_share_one_statement(cpu, stand_in):
    cq = stand_in(cpu.compile(QUERIES[6]))
    want = cq().to_pylist()
    got, errors = [], []

    def call():
        try:
            for _ in range(4):
                got.append(cq().to_pylist())
        except Exception as e:  # reported below
            errors.append(e)

    threads = [threading.Thread(target=call) for _ in range(4)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=120)
    assert not any(t.is_alive() for t in threads) and not errors
    assert got == [want] * 16 and cq.graph_state == "captured"


def test_stand_in_failed_capture_runs_eagerly(cpu, stand_in, monkeypatch):
    def refuse(cls, run, device):
        run()
        raise RuntimeError("operation not permitted when stream is "
                           "capturing")

    monkeypatch.setattr(cuda_graph.StatementGraph, "capture",
                        classmethod(refuse))
    cq = stand_in(cpu.compile(QUERIES[6]))
    want = cq().to_pylist()
    assert [cq().to_pylist() for _ in range(2)] == [want] * 2
    assert cq.graph_state == "eager" and cq._graph is None
    assert "the capture failed: RuntimeError" in cq.graph_reason


def test_stand_in_trace_has_one_replay_span(cpu, stand_in):
    session = Session()
    session.set("compile_queries", True)
    engine = Engine(cpu.catalog, session=session, device="cpu", trace=True)
    engine.sql(QUERIES[3])
    stand_in(engine._compiled_cache[QUERIES[3]])
    eager = engine.sql(QUERIES[3])  # the warm-up
    engine.sql(QUERIES[3])  # the capture and the first replay
    out = engine.sql(QUERIES[3])
    assert _spans(out.trace, "op:GraphReplay") == 1
    assert _spans(out.trace, "fragment") == 0
    assert not [s for s in out.trace.spans
                if s[0].startswith("op:") and s[0] != "op:GraphReplay"]
    run = next(i for i, s in enumerate(out.trace.spans) if s[0] == "run")
    replay = next(s for s in out.trace.spans if s[0] == "op:GraphReplay")
    assert replay[3] == run
    assert _spans(eager.trace, "op:GraphReplay") == 0
    assert _spans(eager.trace, "fragment") == len(
        engine._compiled_cache[QUERIES[3]]._stages)
    assert out.to_pylist() == eager.to_pylist()


def test_host_tables_read_lists_the_tables_of_its_block():
    a, b = np.asarray(["a"]), np.asarray(["b"])
    before = expr_eval._host_tables("test", (a,), "cpu",
                                    lambda: torch.zeros(1))
    with expr_eval.host_tables_read() as read:
        hit = expr_eval._host_tables("test", (a,), "cpu",
                                     lambda: torch.ones(1))
        made = expr_eval._host_tables("test", (b,), "cpu",
                                      lambda: torch.ones(1))
    expr_eval._host_tables("test", (b,), "cpu", lambda: torch.ones(1))
    assert hit is before and len(read) == 2
    assert read[0] is before and read[1] is made


def test_stand_in_graph_keeps_only_the_tables_its_run_read(cpu, stand_in):
    """The graph holds the scan inputs and the two tables its run looked
    up, and no other table of the cache."""
    other = expr_eval._host_tables("test", (np.asarray(["x"]),), "cpu",
                                   lambda: torch.zeros(1))
    cq = stand_in(cpu.compile(TABLES_SQL))
    want = [cq().to_pylist() for _ in range(2)]
    assert cq.graph_state == "captured" and want[0] == want[1]
    keep = cq._graph.keep
    assert len(keep) == len(cq.inputs) + 2
    assert all(a is b for a, b in zip(keep, cq.inputs.values()))
    cached = [v[1] for v in expr_eval._HOST_TABLES.values()]
    assert all(any(t is c for c in cached) for t in keep[len(cq.inputs):])
    assert not any(t is other for t in keep)


@pytest.mark.parametrize("shapes", [
    [((5,), torch.int64), ((5,), torch.bool), ((3, 4), torch.int32)],
    [((0,), torch.float64), ((1,), torch.int8), ((7,), torch.float64)],
])
def test_pack_layout_round_trips(shapes):
    """Every array starts on a 16-byte boundary of the pack and comes back
    as it went in, with the readback pair after them."""
    gen = torch.Generator().manual_seed(7)
    arrays = {f"c{i}": (torch.randint(0, 100, shape, generator=gen)
                        .to(dtype)) for i, (shape, dtype) in
              enumerate(shapes)}
    data = {k: v for k, v in arrays.items() if v.dtype != torch.bool}
    validity = {k: v for k, v in arrays.items() if v.dtype == torch.bool}
    pair = torch.tensor([3, 1], dtype=torch.int64)
    pack, layout, at = cuda_graph._pack(data, validity, pair, "cpu")
    assert at % 16 == 0 and all(off % 16 == 0 for _, _, off, *_ in layout)
    g = cuda_graph.StatementGraph(_Graph(None, pack, "cpu"), pack, layout,
                                  (at,), threading.Lock())
    g.graph.replay = lambda: None
    got_data, got_validity, got_pair = g.replay()
    assert got_pair.tolist() == [3, 1]
    for want, got in ((data, got_data), (validity, got_validity)):
        assert list(got) == list(want)
        for k in want:
            assert got[k].dtype == want[k].dtype
            assert torch.equal(got[k], want[k])


# ------------------------------------------------------------ on the card


@pytest.fixture(scope="module")
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: a CUDA graph has no CPU mode")
    return torch.device("cuda", 0)


@pytest.fixture(scope="module")
def on_card(card):
    engine = _engine(card)
    return engine, _frames(engine)


def _three_runs(cq):
    """The warm-up, the capture with its first replay, and a replay."""
    got = [cq().to_pandas()]
    assert cq.graph_state == "pending", cq.graph_reason
    got += [cq().to_pandas() for _ in range(2)]
    assert cq.graph_state == "captured", cq.graph_reason
    assert cq.graph_reason is None
    return got


@pytest.mark.cuda
@pytest.mark.parametrize("qid", sorted(QUERIES))
def test_replay_matches_eager_and_oracle_on_card(on_card, qid):
    engine, frames = on_card
    for got in _three_runs(engine.compile(QUERIES[qid])):
        assert compare_frames(got, ORACLE[qid](frames)) is None


@pytest.mark.cuda
@pytest.mark.parametrize("qid", SAMPLED)
def test_sampled_replay_matches_oracle_on_card(on_card, card, qid):
    engine, frames = on_card
    cq = CompiledQuery(engine.catalog, engine.plan(QUERIES[qid]),
                       sample=SAMPLE, device=card)
    assert cq.guard_ranges
    for got in _three_runs(cq):
        assert compare_frames(got, ORACLE[qid](frames)) is None


@pytest.mark.cuda
def test_batches_are_copies_on_card(on_card):
    engine, _ = on_card
    cq = engine.compile("select sum(l_quantity) as q, count(*) as n "
                        "from lineitem where l_shipdate < date '1995-01-01'")
    _three_runs(cq)
    _answers_kept(engine, cq)


@pytest.mark.cuda
def test_overflow_raises_through_a_replay_on_card(on_card):
    engine, _ = on_card
    cq = _planted_overflow(engine)
    for _ in range(3):
        with pytest.raises(ExecError, match="overflow"):
            cq()
    assert cq.graph_state == "captured" and cq.graph_reason is None
    with pytest.raises(ExecError, match="overflow"):
        cq.block_run(reps=2)


@pytest.mark.cuda
def test_grouped_and_stubbed_run_eagerly_on_card(on_card, card):
    engine, frames = on_card
    grouped = engine.compile_grouped(QUERIES[1], n_groups=2)
    for _ in range(3):
        got = grouped().to_pandas()
        assert compare_frames(got, ORACLE[1](frames)) is None
    assert grouped._programs
    for cq in grouped._programs.values():
        assert cq._graph is None and "scan inputs" in cq.graph_reason
    cq, stubs = _stubbed(engine, card)
    want = engine.sql(QUERIES[6]).to_pylist()
    assert [cq(stubs=stubs).to_pylist() for _ in range(3)] == [want] * 3
    assert cq.graph_state == "eager" and cq._graph is None
    assert "external inputs" in cq.graph_reason


@pytest.mark.cuda
def test_threads_capture_their_statements_on_card(on_card):
    """Four threads, each warming up, capturing and replaying its own
    statement at once: every statement is captured (a capture does not
    break another thread's) and answers as its eager warm-up did."""
    engine, _ = on_card
    cqs = [engine.compile(QUERIES[q]) for q in (1, 3, 6, 7)]
    got = {i: [] for i in range(len(cqs))}
    errors = []

    def calls(i):
        try:
            for _ in range(4):
                got[i].append(cqs[i]().to_pylist())
        except Exception as e:  # reported below
            errors.append(e)

    threads = [threading.Thread(target=calls, args=(i,))
               for i in range(len(cqs))]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=300)
    assert not any(t.is_alive() for t in threads) and not errors
    for i, cq in enumerate(cqs):
        assert cq.graph_state == "captured", cq.graph_reason
        assert got[i] == [got[i][0]] * 4


@pytest.mark.cuda
def test_trace_has_one_replay_span_on_card(card):
    # "cuda" without an index, as the benchmark and most callers name it
    engine = _engine("cuda", compiled=True, trace=True)
    for qid in (1, 3):
        outs = [engine.sql(QUERIES[qid]) for _ in range(3)]
        assert _spans(outs[0].trace, "fragment") > 0
        assert _spans(outs[0].trace, "op:GraphReplay") == 0
        assert _spans(outs[2].trace, "op:GraphReplay") == 1
        assert _spans(outs[2].trace, "fragment") == 0
        assert outs[2].to_pylist() == outs[0].to_pylist()


@pytest.mark.cuda
def test_statements_replay_on_their_own_streams_on_card(on_card):
    """Statements captured into the device's one pool, each replayed by its
    own thread on its own stream at once: each replay waits for the one
    before it on the device, so every answer is its eager warm-up's."""
    engine, _ = on_card
    cqs = [engine.compile(sql) for sql in
           (QUERIES[1], QUERIES[3], QUERIES[6], QUERIES[7], TABLES_SQL)]
    want = []
    for cq in cqs:
        want.append(cq().to_pylist())
        assert cq().to_pylist() == want[-1]
        assert cq.graph_state == "captured", cq.graph_reason
    got = {i: [] for i in range(len(cqs))}
    errors = []

    def calls(i):
        try:
            with torch.cuda.stream(torch.cuda.Stream()):
                for _ in range(6):
                    got[i].append(cqs[i]().to_pylist())
        except Exception as e:  # reported below
            errors.append(e)

    threads = [threading.Thread(target=calls, args=(i,))
               for i in range(len(cqs))]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=300)
    assert not any(t.is_alive() for t in threads) and not errors
    for i, cq in enumerate(cqs):
        assert cq.graph_reason is None
        assert got[i] == [want[i]] * 6


def _pool_bytes():
    """{memory pool id: bytes reserved for it} on the current device."""
    out = {}
    for seg in torch.cuda.memory_snapshot():
        key = tuple(seg["segment_pool_id"])
        out[key] = out.get(key, 0) + seg["total_size"]
    return out


@pytest.mark.cuda
def test_captures_share_one_pool_on_card(on_card):
    """Four statements of one text capture into the device's one pool:
    no capture makes a pool of its own, and the three after the first
    reuse its intermediates' memory (each adds only its packed outputs)."""
    engine, frames = on_card
    cqs = [engine.compile(QUERIES[9]) for _ in range(4)]
    for cq in cqs:
        cq()  # the warm-ups, before any capture
    before = _pool_bytes()
    first = cqs[0]().to_pandas()
    pool = tuple(cuda_graph._DEVICES[torch.cuda.current_device()].pool)
    after_first = _pool_bytes()
    rest = [cq().to_pandas() for cq in cqs[1:]]
    after_rest = _pool_bytes()
    assert all(cq.graph_state == "captured" for cq in cqs)
    assert set(after_rest) - set(before) <= {pool}
    assert after_first[pool] > 0
    assert after_rest[pool] - after_first[pool] <= 2 * 2 ** 20
    for got in [first] + rest:
        assert compare_frames(got, ORACLE[9](frames)) is None


@pytest.mark.cuda
def test_capture_after_every_graph_is_gone_on_card(on_card):
    """The device's pool outlives its graphs: a statement captures and
    replays after every earlier statement and its graph were freed."""
    engine, frames = on_card
    cq = engine.compile(QUERIES[6])
    _three_runs(cq)
    del cq
    gc.collect()
    for got in _three_runs(engine.compile(QUERIES[14])):
        assert compare_frames(got, ORACLE[14](frames)) is None
