"""Sampled discovery in the port (``exec/sampling.py``,
``CompiledQuery(sample=...)``, ``Engine.compile(sample="auto")``) and the
compiled path's per-fragment profile (``CompiledQuery.profile``,
``Engine.explain_analyze``), against the JAX package at SF 0.01.

A sampled compiled query answers what the JAX package's ``Engine.sql``
answers, row for row; its extrapolated capacities, widened key ranges and
boundary capacities equal the JAX package's record and ``_caps``, path by
path; an adversarially small margin raises ``ExecError`` instead of
truncating.  Integers, decimals, dates and strings exact; doubles to 1e-6
relative.
"""

import numpy as np
import pytest
import torch

import presto1_tpu.exec.catalog as j_catalog
import presto1_tpu.exec.engine as j_engine
import presto1_tpu.exec.executor as j_executor
import presto1_tpu.exec.stats as j_stats
import presto1_tpu_torch.exec.catalog as t_catalog
import presto1_tpu_torch.exec.engine as t_engine
import presto1_tpu_torch.exec.session as t_session
from presto1_tpu_torch.exec import sampling
from presto1_tpu_torch.exec.executor import CompiledQuery, ExecError
from presto1_tpu_torch.tpch.queries import QUERIES

from test_tpch import assert_frames_match

torch.set_num_threads(1)

SAMPLE = {"lineitem": 8}


@pytest.fixture(scope="module")
def engines():
    return (j_engine.Engine(j_catalog.TpchCatalog(sf=0.01)),
            t_engine.Engine(t_catalog.TpchCatalog(sf=0.01, device="cpu"),
                            device="cpu"))


# q18 = HAVING on a prefix-clustered group (the selectivity-preservation
# case); q9/q5 = deep join chains over unsampled dimensions; q17 =
# correlated avg subquery; q1/q3/q6 = the bench anchors; q20 = semi-join
# pushdown chain
@pytest.mark.parametrize("qid", [1, 3, 5, 6, 9, 17, 18, 20])
def test_sampled_matches_the_reference(engines, qid):
    je, te = engines
    cq = CompiledQuery(te.catalog, te.plan(QUERIES[qid]), sample=SAMPLE,
                       device="cpu")
    assert cq.guard_ranges
    assert_frames_match(cq().to_pandas(), je.sql(QUERIES[qid]).to_pandas(),
                        ordered=True)


def _recorded(record):
    """The extrapolated entries of a record: capacities and key ranges."""
    out = {}
    for path, rec in record.items():
        for key, v in rec.items():
            if key in sampling.CAP_KEYS or (
                    isinstance(key, str) and key.startswith("ranges")):
                out[(path, key)] = [tuple(r) for r in v] \
                    if isinstance(v, list) else v
    return out


@pytest.mark.parametrize("qid", [1, 3, 18])
def test_extrapolated_record_equals_the_reference(engines, qid):
    """Capacities (``sampling.CAP_KEYS``), key ranges and fragment-boundary
    capacities after extrapolation, path by path: both records hold the
    same such keys, with equal values (the JAX package's discovery only;
    nothing compiles)."""
    je, te = engines
    tq = CompiledQuery(te.catalog, te.plan(QUERIES[qid]), sample=SAMPLE,
                       device="cpu")
    jq = j_executor.CompiledQuery(je.catalog, je.plan(QUERIES[qid]),
                                  sample=SAMPLE)
    got, want = _recorded(tq.record), _recorded(jq.record)
    assert got and set(got) == set(want)
    assert got == want
    assert tq._caps == jq._caps


def test_sampled_overflow_guard_raises_not_truncates(engines):
    """An absurdly small margin under-extrapolates; the compiled run must
    detect the overflow (device-side guards), not silently truncate."""
    _, te = engines
    plan = te.plan(QUERIES[3])
    cq = CompiledQuery(te.catalog, plan, sample={"lineitem": 64},
                       device="cpu")
    floor = sampling.CAP_FLOOR
    try:
        sampling.CAP_FLOOR = 1
        cq_small = CompiledQuery(te.catalog, plan, sample={"lineitem": 64},
                                 sample_margin=0.001, device="cpu")
    finally:
        sampling.CAP_FLOOR = floor
    with pytest.raises(ExecError):
        cq_small()
    with pytest.raises(ExecError):
        cq_small.block_run(reps=2)
    # and the honest margin still runs
    assert len(cq().to_pandas()) > 0


def test_auto_policy_spares_small_catalogs(engines):
    _, te = engines
    assert sampling.choose_sample(te.catalog,
                                  te.plan(QUERIES[1])) is None


def test_choose_sample_targets_largest_table(engines):
    _, te = engines
    s = sampling.choose_sample(te.catalog, te.plan(QUERIES[3]),
                               threshold=10_000, target=5_000)
    assert s is not None and list(s) == ["lineitem"]
    n = te.catalog.table("lineitem").num_rows
    assert s["lineitem"] == max(2, int(np.ceil(n / 5_000)))


@pytest.mark.parametrize("switch,want", [(None, SAMPLE), ("0", None),
                                         ("off", None)])
def test_compile_auto_and_the_discovery_sample_switch(
        engines, monkeypatch, switch, want):
    _, te = engines
    monkeypatch.setattr(sampling, "choose_sample",
                        lambda catalog, plan: dict(SAMPLE))
    if switch is None:
        monkeypatch.delenv("P1_DISCOVERY_SAMPLE", raising=False)
    else:
        monkeypatch.setenv("P1_DISCOVERY_SAMPLE", switch)
    cq = te.compile(QUERIES[6])
    assert cq.sample == want
    assert te.compile(QUERIES[6], sample=None).sample is None


def test_profile_and_explain_analyze_per_fragment(engines):
    """The compiled path's EXPLAIN ANALYZE: one line per fragment root,
    with the rows that the JAX package's eager operator stats report at
    the same plan paths."""
    je, te = engines
    sql = QUERIES[3]
    cq = te.compile(sql, sample=None)
    frags = cq.profile(reps=2)
    assert [r for r, _, _, _ in frags] == [r for r, _, _ in cq._stages]
    assert all(wall > 0 and nbytes > 0 for _, wall, _, nbytes in frags)
    stats = j_stats.QueryStats()
    j_executor.Executor(je.catalog, stats=stats).execute(je.plan(sql))
    assert {r: rows for r, _, rows, _ in frags} == \
        {r: stats.operators[r].output_rows for r, _, _, _ in frags}
    s = t_session.Session()
    s.set("compile_queries", True)
    text = t_engine.Engine(te.catalog, session=s,
                           device="cpu").explain_analyze(sql)
    assert f"compiled path: {len(frags)} fragments" in text
    assert text.count("MB out") == len(frags)
    eager = te.explain_analyze(sql)
    assert eager.startswith("Query: ") and "rows]" in eager
