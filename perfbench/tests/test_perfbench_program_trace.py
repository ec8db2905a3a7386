"""The program-span metrics: the helper that puts the device's idle time
down to the innermost program span open (on fake profiler events, as
``test_perfbench_trace.py`` tests the harness's reduction), and the six
readers over a replay on the CPU at SF 0.01."""

import importlib
import json
import types

import pytest
import torch

from perfbench.metrics import _program_trace as pt
from presto1_tpu_torch.ops.kernels import COUNTERS, gather

from .helpers import CELLS, store, traffic

CUDA = torch.autograd.DeviceType.CUDA
READERS = ("parse_plan_ms", "statement_self_ms", "enqueue_ms_per_query",
           "host_syncs_per_query", "host_wait_ms_per_query",
           "to_host_ms_per_query")


def event(name, start_us, end_us):
    return types.SimpleNamespace(
        name=name, device_type=CUDA, is_user_annotation=False,
        time_range=types.SimpleNamespace(start=start_us, end=end_us))


class Prof:
    def __init__(self, events):
        self._events = events

    def events(self):
        return self._events


def fake_trace(spans):
    """A QueryTrace-shaped object from ``(name, start, end, parent)``."""
    return types.SimpleNamespace(
        spans=[[n, a, b, p, None] for n, a, b, p in spans])


def test_innermost_pieces_and_overlap():
    spans = [(0, 100, "statement"), (10, 30, "parse"), (40, 90, "run"),
             (70, 80, "wait"), (120, 150, "to_host")]
    assert pt.pieces(spans) == [
        (0, 10, "statement"), (10, 30, "parse"), (30, 40, "statement"),
        (40, 70, "run"), (70, 80, "wait"), (80, 90, "run"),
        (90, 100, "statement"), (120, 150, "to_host")]
    idle = [(5, 15), (75, 125), (140, 200)]
    assert pt.overlap_by_name(idle, pt.pieces(spans)) == {
        "statement": 5 + 10, "parse": 5, "wait": 5, "run": 10,
        "to_host": 5 + 10}
    assert pt.idle_intervals([(10, 20), (15, 30), (50, 60)], 0, 55) == [
        (0, 10), (30, 50)]
    assert pt.idle_intervals([(0, 10)], 0, 10) == []


def test_idle_by_innermost_span_on_a_fake_trace():
    # trace clock (us): spins end at 100; the host saw the synchronize
    # return at 1,000,000 ns, so host_ns = us * 1e3 + 900,000
    evs = [event("spin_kernel", 0, 100), event("k1", 200, 300),
           event("k2", 700, 800)]
    # two calls of q6: 1.05-1.5 ms and 1.5-1.95 ms on the host's clock
    outer = [(1_050_000, 1_500_000, "q6"), (1_500_000, 1_950_000, "q6")]
    traces = [
        fake_trace([("statement", 1_060_000, 1_400_000, None),
                    ("run", 1_080_000, 1_390_000, 0),
                    ("wait", 1_300_000, 1_390_000, 1),
                    ("to_host", 1_410_000, 1_490_000, None)]),
        fake_trace([("statement", 1_510_000, 1_900_000, None),
                    ("to_host", 1_910_000, 1_940_000, None)]),
    ]
    busy = pt.device_busy_ns(Prof(evs), 1_000_000)
    assert busy == [(1_100_000, 1_200_000), (1_600_000, 1_700_000)]
    out = pt._idle({"outer": outer, "prof": Prof(evs),
                    "sync_ns": 1_000_000}, traces, ["q6", "q6"])
    assert out["aligned"]
    idle = out["idle_ms"]["q6"]
    # idle: 1.05-1.1, 1.2-1.6 and 1.7-1.95 ms
    assert idle["run"] == pytest.approx(0.02 + 0.1)
    assert idle["wait"] == pytest.approx(0.09)
    assert idle["statement"] == pytest.approx(0.02 + 0.01 + 0.09 + 0.2)
    assert idle["to_host"] == pytest.approx(0.08 + 0.03)
    assert idle["outside"] == pytest.approx(
        0.01 + 0.01 + 0.01 + 0.01 + 0.01 + 0.01)
    assert out["idle_total_ms"] == pytest.approx(0.05 + 0.4 + 0.25)
    assert out["idle_between_calls_ms"] == pytest.approx(0.0)
    assert out["idle_in_program_spans_share"] == pytest.approx(
        (0.7 - 0.06) / 0.7)
    # the harness's gap names, from the program's spans
    names = dict((round(s * 1e6), n) for n, s in out["gaps"])
    assert names[400] == "q6:statement"


def test_without_the_spins_nothing_is_put_down():
    out = pt._idle({"outer": [(0, 10, "q1")], "prof": Prof(
        [event("k1", 0, 5)]), "sync_ns": 0},
        [fake_trace([("statement", 1, 9, None)])], ["q1"])
    assert not out["aligned"] and "idle_ms" not in out


def _run(cell, queries):
    from presto1_tpu_torch.exec.engine import Engine
    from presto1_tpu_torch.exec.session import Session

    from perfbench.harness import Run
    from perfbench.port_catalog import BenchCatalog
    from .helpers import mix

    tr = traffic(cell, None)
    session = Session()
    for k, v in mix(cell.split(".")[1])["session"].items():
        session.set(k, v)
    engine = Engine(BenchCatalog(store(cell.split(".")[0]), device="cpu"),
                    session=session, device="cpu")
    for inst in tr.instances:
        engine.sql(inst.text).to_pylist()
    insts = (tr.instances * queries)[:queries]
    return Run(trace=None, traced=insts, engine=engine,
               texts=sorted({i.text for i in insts}), store=None,
               device_kind="cpu", peaks={})


@pytest.mark.parametrize("cell", CELLS)
def test_the_six_readers_on_a_cpu_replay(cell, capsys):
    run = _run(cell, 8)
    values = {m: importlib.import_module(f"perfbench.metrics.{m}").read(run)
              for m in READERS}
    assert run.engine.trace is False
    for m in ("enqueue_ms_per_query", "host_syncs_per_query",
              "to_host_ms_per_query", "statement_self_ms"):
        assert values[m] > 0, (m, values)
    assert values["host_wait_ms_per_query"] >= 0
    if cell.endswith("adhoc"):
        assert values["parse_plan_ms"] > 0
        # the eager executor reads row counts back at every operator
        assert values["host_syncs_per_query"] > 3
    else:
        # a compiled statement answers from its plan cache
        assert values["parse_plan_ms"] == 0
    line = [ln for ln in capsys.readouterr().err.splitlines()
            if '"program_trace"' in ln]
    assert len(line) == 1  # computed once for the six readers
    detail = json.loads(line[0])["program_trace"]
    assert detail["metrics"] == values
    assert detail["root_spans_over_latency"] > 0.5
    assert set(detail["tracing_cost"]) == {i.name for i in run.traced}
    for name, t in detail["templates"].items():
        assert t["spans"]["wait"] >= 2, name
        assert "statement" in t["self_ms"] and "to_host" in t["self_ms"]
        assert set(t["launches"]) == set(COUNTERS), name


def test_a_program_without_traces_gives_no_metric():
    from perfbench.harness import Run

    class Engine:  # an engine that keeps no trace (no ``trace`` switch)
        pass

    run = Run(trace=None, traced=[object()], engine=Engine(), texts=[],
              store=None, device_kind="cpu", peaks={})
    for m in READERS:
        assert importlib.import_module(f"perfbench.metrics.{m}").read(
            run) is None


def test_sync_check_counts_torchs_warnings_beside_the_waits(monkeypatch):
    import warnings

    traces = []

    class Batch:
        def to_pylist(self):
            warnings.warn("called a synchronizing CUDA operation")
            return []

    class Engine:
        def sql(self, text):
            warnings.warn("called a synchronizing CUDA operation")
            warnings.warn("another warning")
            traces.append(fake_trace([("statement", 0, 9, None),
                                      ("wait", 1, 2, 0), ("wait", 3, 4, 0)]))
            return Batch()

    modes = []
    monkeypatch.setattr(torch.cuda, "set_sync_debug_mode", modes.append)
    insts = [types.SimpleNamespace(name=n, text="") for n in ("q1", "q6")]
    out = pt._sync_counts(Engine(), insts * 2, traces)
    assert modes == ["warn", 0]
    assert out["per_query"] == {"q1": {"torch": 2, "waits": 2},
                                "q6": {"torch": 2, "waits": 2}}
    assert sum(n for _, n in out["sites"]) == 8


def test_replay_counts_each_calls_launches_by_family(monkeypatch):
    class Batch:
        def to_pylist(self):
            return []

    class Engine:  # a stand-in launch per call, two for q7
        def sql(self, text):
            gather.LAUNCHES += 2 if text == "q7" else 1
            return Batch()

    monkeypatch.setattr(gather, "LAUNCHES", gather.LAUNCHES)
    insts = [types.SimpleNamespace(name=n, text=n) for n in ("q6", "q7")]
    out = pt._replay(Engine(), insts, torch.device("cpu"))
    assert [o[2] for o in out["outer"]] == ["q6", "q7"]
    assert [n["gather"] for n in out["launches"]] == [1, 2]
    assert all(set(n) == set(COUNTERS) for n in out["launches"])
    assert all(n[k] == 0 for n in out["launches"] for k in n
               if k != "gather")
