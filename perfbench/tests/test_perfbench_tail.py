"""The tail read per layer (``query_p95_ms``), and the cells' metrics as
``BENCHMARK.json`` assigns them: every cell reports ``setup_s``, another
end-to-end metric and a per-layer one, and each per-layer metric moves an
end-to-end metric that its cells report."""

import importlib
import json
import os
import types

import numpy as np
import pytest

from perfbench.harness import ROOT, Record, metrics_of

with open(os.path.join(ROOT, "BENCHMARK.json")) as f:
    BENCH = json.load(f)
CELLS = [w["name"] for w in BENCH["workloads"]]


def _run(latencies):
    return types.SimpleNamespace(untraced=[
        Record(None, x, None, float(k), 0, None)
        for k, x in enumerate(latencies)])


def test_query_p95_reads_the_untraced_rest():
    read = importlib.import_module("perfbench.metrics.query_p95_ms").read
    lat = list(np.random.default_rng(5).gamma(2.0, 0.004, size=997))
    assert read(_run(lat)) == pytest.approx(
        float(np.percentile(lat, 95)) * 1e3)
    assert read(_run([])) is None


@pytest.mark.parametrize("cell", CELLS)
def test_each_cell_reports_what_the_contract_asks(cell):
    w = next(x for x in BENCH["workloads"] if x["name"] == cell)
    e2e = {m["name"] for m in metrics_of(BENCH, w, "end_to_end")}
    layer = metrics_of(BENCH, w, "per_layer")
    assert "setup_s" in e2e and len(e2e) >= 2
    assert layer
    for m in layer:
        assert m["moves"] in e2e, (cell, m["name"])
        assert os.path.exists(os.path.join(
            ROOT, "perfbench", "metrics", m["name"] + ".py")), m["name"]


def test_the_tail_is_bounded_where_it_is_steady_and_read_per_layer_else():
    p95 = next(m for m in BENCH["end_to_end"]
               if m["name"] == "latency_p95_ms")
    tail = next(m for m in BENCH["per_layer"] if m["name"] == "query_p95_ms")
    assert set(p95["workloads"]) | set(tail["workloads"]) == set(CELLS)
    assert not set(p95["workloads"]) & set(tail["workloads"])
