"""TPC-DS Q27, Q93 and Q98 as the specification writes them, through the
port on the benchmark's star schema (``perfbench/data/tpcds.py``) at SF
0.01 on the CPU: every instance of the star mix and of three other
instance seeds, eager and compiled, against the plain reference
(``perfbench/reference/tpcds_q*.py``), each answer non-empty; the
generator's keys; and the operator reruns that ``op:`` spans and a
replay's ``op:GraphReplay`` detail both count."""

import functools
import json
import os

import numpy as np
import pytest
import torch

from perfbench.data.store import Store
from perfbench.metrics.operator_reruns_per_query import reruns
from perfbench.port_catalog import BenchCatalog
from perfbench.reference.common import judge
from perfbench.traffic import Traffic
from presto1_tpu_torch.exec import cuda_graph
from presto1_tpu_torch.exec.engine import Engine
from presto1_tpu_torch.exec.session import Session

from test_torch_graph_replay import _capture_on_cpu

torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SF = 0.01
SEEDS = (None, 5, 2 ** 31 + 11, 123456789)


@functools.lru_cache(maxsize=None)
def store() -> Store:
    return Store({"name": "tpcds-sf1", "suite": "tpcds",
                  "scale_factor": SF}, cache=None)


def traffic(seed) -> Traffic:
    with open(os.path.join(ROOT, "perfbench", "mixes", "star.json")) as f:
        mix = json.load(f)
    return Traffic(mix, "tpcds", seed or 0, instance_seed=seed)


@functools.lru_cache(maxsize=None)
def engine(compiled: bool) -> Engine:
    session = Session()
    session.set("compile_queries", compiled)
    return Engine(BenchCatalog(store(), device="cpu"), session=session,
                  device="cpu")


@functools.lru_cache(maxsize=None)
def context(name: str):
    module = traffic(None).templates[name]
    tables = {t: {c: store().column(t, c) for c in cols}
              for t, cols in module.COLUMNS.items()}
    return module.prepare(tables)


@pytest.mark.parametrize("compiled", [False, True], ids=["eager", "compiled"])
@pytest.mark.parametrize("seed", SEEDS, ids=str)
@pytest.mark.parametrize("template", ["q27", "q93", "q98"])
def test_spec_template_matches_the_reference(template, seed, compiled):
    tr = traffic(seed)
    module = tr.templates[template]
    eng = engine(compiled)
    for inst in tr.by_template[template]:
        want = module.answer(context(template), inst.params)
        for _ in range(2 if compiled else 1):  # compile, then the fragments
            got = eng.sql(inst.text).to_pylist()
            ok, worst = judge(got, want, module.OUTPUT, module.ORDER_KEY,
                              module.LIMIT)
            assert ok, (inst.text, got[:3], want[:3])
            assert worst <= 1e-12, (inst.text, worst)
            assert len(got) > 0, inst.text
            # every template's ORDER BY is unique on its rows: the exact
            # columns come in the reference's order, row for row
            exact = [j for j, k in enumerate(module.OUTPUT) if k == "exact"]
            assert [[r[j] for j in exact] for r in got] == \
                [[r[j] for j in exact] for r in want[:len(got)]]


def _columns(table: str, names):
    return [store().column(table, c) for c in names]


@pytest.mark.parametrize("table", ["date_dim", "item", "customer_demographics",
                                   "store", "reason", "store_sales",
                                   "store_returns"])
def test_declared_unique_keys_hold(table):
    for key in store().suite.unique_keys(table):
        cols = _columns(table, key)
        assert all(c.validity is None or c.validity.all() for c in cols)
        rows = np.stack([c.data.astype(np.int64) for c in cols], axis=1)
        assert len(np.unique(rows, axis=0)) == store().num_rows(table), key


def test_every_return_is_one_sold_line():
    ss = _columns("store_sales", ["ss_item_sk", "ss_ticket_number",
                                  "ss_customer_sk", "ss_quantity"])
    sr = _columns("store_returns", ["sr_item_sk", "sr_ticket_number",
                                    "sr_customer_sk", "sr_return_quantity"])
    sold = {(i, t): k for k, (i, t) in
            enumerate(zip(ss[0].data.tolist(), ss[1].data.tolist()))}
    lines = [sold[(i, t)] for i, t in zip(sr[0].data.tolist(),
                                         sr[1].data.tolist())]
    assert len(set(lines)) == len(lines) == store().num_rows("store_returns")
    lines = np.array(lines)
    assert np.array_equal(sr[2].data, ss[2].data[lines])
    assert np.array_equal(sr[2].valid(), ss[2].valid()[lines])
    qty = sr[3].data
    assert (qty >= 1).all() and (qty <= ss[3].data[lines]).all()
    reason = store().column("store_returns", "sr_reason_sk")
    known = reason.data[reason.valid()]
    assert known.min() >= 1 and known.max() <= 35


def test_spec_domains():
    st = store()
    assert len(st.column("reason", "r_reason_desc").dictionary) == 35
    assert len(st.column("item", "i_category").dictionary) == 10
    cd = st.column("customer_demographics", "cd_demo_sk")
    assert len(cd.data) == 1_920_800
    years = st.column("date_dim", "d_year").data[
        np.searchsorted(st.column("date_dim", "d_date_sk").data,
                        st.column("store_sales", "ss_sold_date_sk").data)]
    assert set(range(1998, 2003)) <= set(years.tolist())


@pytest.mark.parametrize("template", ["q27", "q93", "q98"])
def test_replay_detail_counts_the_eager_spans_reruns(template, monkeypatch):
    monkeypatch.setattr(cuda_graph.StatementGraph, "capture",
                        classmethod(_capture_on_cpu))
    session = Session()
    session.set("compile_queries", True)
    eng = Engine(BenchCatalog(store(), device="cpu"), session=session,
                 device="cpu", trace=True)
    text = traffic(None).by_template[template][0].text
    eng.sql(text).to_pylist()  # compiles
    cq = next(iter(eng._compiled_cache.values()))
    cq._graph_never, cq.graph_state = None, "pending"  # as on a card
    eager = eng.sql(text)  # the warm-up runs the fragments
    eng.sql(text).to_pylist()  # captures
    replayed = eng.sql(text)
    assert cq.graph_state == "captured"
    detail = [s[4] for s in replayed.trace.spans if s[0] == "op:GraphReplay"]
    assert len(detail) == 1
    ops = [s for s in eager.trace.spans if s[0].startswith("op:")]
    assert detail[0]["operators"] == len(ops)
    assert detail[0]["reruns"] == reruns(eager.trace) == reruns(
        replayed.trace)
    if template == "q27":
        # the star join below the ROLLUP's Union, again in the two sets
        # after the first (the grand total's prunes the item scan's id)
        assert detail[0]["reruns"] > 0
    else:
        assert detail[0]["reruns"] == 0
    assert replayed.to_pylist() == eager.to_pylist()
