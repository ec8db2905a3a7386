"""The star cell, ``tpcds-sf1.star``, on the CPU at SF 0.01: the plain
reference against the port for the mix's own instances and three other
sets, in the cell's compiled session; the control not correct; a run with
the timed path broken (an altered answer, a stale answer, half the fact
rows left out) not correct, and the same run unbroken correct; the plans
over the benchmark's catalog equal to those over the port's own
``TpcdsCatalog`` at SF 1, where both declare the same statistics; and the
operator-reruns reader on a CPU replay."""

import functools
import importlib
import json
import os
import re

import pytest

from perfbench.control import readings
from perfbench.data.store import Store
from perfbench.harness import Run, run
from perfbench.reference.common import judge

from .helpers import SEEDS, SF, mix
from .test_perfbench_faults import _altered, _stale

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CELL, CONFIG, SUITE = "tpcds-sf1.star", "tpcds-sf1", "tpcds"
TABLES = ("date_dim", "item", "customer_demographics", "store", "reason",
          "store_sales", "store_returns")


@functools.lru_cache(maxsize=None)
def store(sf: float = SF) -> Store:
    return Store({"name": CONFIG, "suite": SUITE, "scale_factor": sf},
                 cache=None)


def traffic(seed):
    from perfbench.traffic import Traffic

    return Traffic(mix("star"), SUITE, seed or 0, instance_seed=seed)


@functools.lru_cache(maxsize=None)
def engine(compiled: bool = True):
    from presto1_tpu_torch.exec.engine import Engine
    from presto1_tpu_torch.exec.session import Session

    from perfbench.port_catalog import BenchCatalog

    session = Session()
    session.set("compile_queries", compiled)
    return Engine(BenchCatalog(store(), device="cpu"), session=session,
                  device="cpu")


def tables(module) -> dict:
    return {t: {c: store().column(t, c) for c in cols}
            for t, cols in module.COLUMNS.items()}


@pytest.mark.parametrize("seed", (None,) + SEEDS)
def test_reference_agrees_with_the_port(seed):
    tr = traffic(seed)
    eng = engine(tr.mix["session"]["compile_queries"])
    for name, module in tr.templates.items():
        ctx = module.prepare(tables(module))
        for inst in tr.by_template[name]:
            want = module.answer(ctx, inst.params)
            got = eng.sql(inst.text).to_pylist()
            ok, worst = judge(got, want, module.OUTPUT, module.ORDER_KEY,
                              module.LIMIT)
            assert ok, (inst.text, got[:3], want[:3])
            assert worst <= 1e-12, (inst.text, worst)
            assert len(got) > 0, inst.text


@pytest.mark.parametrize("seed", (None,) + SEEDS)
def test_control_is_not_correct(seed):
    with open(os.path.join(HERE, "configs", CONFIG + ".json")) as f:
        limits = json.load(f)["limits"]
    r = readings(traffic(seed), store())
    assert r["wrong_answers"] > limits["wrong_answers"] \
        or r["double_rel_err"] > limits["double_rel_err"], r


def _half_facts(monkeypatch):
    """The fact tables' scans see their first half only."""
    from perfbench.port_catalog import BenchTable

    plain_rows, plain_load = BenchTable.num_rows, BenchTable._load

    def facts(self):
        return self.name in ("store_sales", "store_returns")

    def num_rows(self):
        n = plain_rows.fget(self)
        return max(n // 2, 1) if facts(self) else n

    def _load(self, name, device):
        c = plain_load(self, name, device)
        n = num_rows(self)
        return type(c)(c.data[:n], c.type,
                       validity=None if c.validity is None
                       else c.validity[:n], dictionary=c.dictionary)

    monkeypatch.setattr(BenchTable, "num_rows", property(num_rows))
    monkeypatch.setattr(BenchTable, "_load", _load)


FAULTS = {"none": None, "altered": _altered, "stale": _stale,
          "half_fact_rows": _half_facts}


@pytest.mark.parametrize("fault", list(FAULTS))
def test_a_broken_run_is_not_correct(fault, monkeypatch):
    if FAULTS[fault] is not None:
        FAULTS[fault](monkeypatch)
    out = run(CELL, 2 ** 33 + 7, 2.0, False, device="cpu",
              config_override={"scale_factor": SF}, data_cache=None)
    assert out["correct"] is (fault == "none"), out["checks"]
    assert list(out)[-1] == "checks"
    assert {"queries_per_s", "geomean_ms", "latency_p95_ms",
            "setup_s"} <= set(out["metrics"])


def _symbols_numbered_apart(plan: str) -> str:
    """A plan's text with its symbols' counters taken out: the benchmark's
    tables hold fewer columns than the port's, so the planner numbers the
    same symbols apart."""
    return re.sub(r"#\d+", "#", plan)


@pytest.mark.parametrize("seed", (None,) + SEEDS)
def test_same_plans_as_the_ports_catalog_at_sf1(seed):
    from presto1_tpu_torch.exec.engine import Engine
    from presto1_tpu_torch.tpcds.catalog import TpcdsCatalog

    from perfbench.port_catalog import BenchCatalog

    bench = Engine(BenchCatalog(store(1.0), device="cpu"), device="cpu")
    own = Engine(TpcdsCatalog(sf=1.0, device="cpu"), device="cpu")
    for inst in traffic(seed).instances:
        assert _symbols_numbered_apart(bench.explain(inst.text)) == \
            _symbols_numbered_apart(own.explain(inst.text)), inst.text
    assert store(1.0).generated == 0  # plans read no data


def test_same_metadata_as_the_ports_catalog_at_sf1():
    from presto1_tpu_torch.tpcds.catalog import TpcdsCatalog

    from perfbench.port_catalog import BenchCatalog

    bench = BenchCatalog(store(1.0), device="cpu")
    own = TpcdsCatalog(sf=1.0, device="cpu")
    for name in TABLES:
        mine, theirs = bench.table(name), own.table(name)
        assert mine.num_rows == theirs.num_rows, name
        assert mine.unique_keys == [tuple(k) for k in theirs.unique_keys]
        assert mine.sort_columns == theirs.sort_columns, name
        for col in mine.column_order:
            assert str(mine.schema[col]) == str(theirs.schema[col]), col
            assert mine.column_stats(col) == theirs.column_stats(col), col


def test_operator_reruns_reader_on_a_cpu_replay(capsys):
    eng = engine(True)
    tr = traffic(None)
    for inst in tr.instances:
        eng.sql(inst.text).to_pylist()
    insts = tr.instances * 2
    ctx = Run(trace=None, traced=insts, engine=eng, texts=[], store=None,
              device_kind="cpu", peaks={})
    reader = importlib.import_module(
        "perfbench.metrics.operator_reruns_per_query")
    value = reader.read(ctx)
    assert eng.trace is False
    line = [json.loads(ln)["operator_reruns"]
            for ln in capsys.readouterr().err.splitlines()
            if '"operator_reruns"' in ln]
    assert line and line[0]["q93"] == line[0]["q98"] == 0
    assert line[0]["q27"] > 0
    # a third of the queries are Q27's
    assert value == pytest.approx(line[0]["q27"] / 3)


def test_reader_gives_nothing_for_a_program_without_node_ids():
    from perfbench.metrics.operator_reruns_per_query import reruns

    class Trace:
        spans = [["op:Scan", 0, 1, None, None],
                 ["op:GraphReplay", 1, 2, None, None]]

    assert reruns(Trace) is None
    Trace.spans = [["op:Output", 0, 3, None, 0], ["op:Scan", 1, 2, 0, 1],
                   ["op:Scan", 2, 3, 0, 1]]
    assert reruns(Trace) == 1
    Trace.spans = [["statement", 0, 1, None, None]]
    assert reruns(Trace) is None
