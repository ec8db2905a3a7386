"""The port's resource groups (``presto1_tpu_torch/server/resource_groups.py``)
and fair task executor (``server/task_executor.py``) on the CPU: twins of
``tests/test_resource_groups.py`` and ``tests/test_task_executor.py``, each
held against the JAX package's module on the same inputs (the same selected
groups, the same admission order, the same levels), and the coordinator's
wiring of resource groups with a ``device="cpu"`` engine.
"""

import threading
import time

import pytest
import torch

import presto1_tpu.server.resource_groups as j_rg
import presto1_tpu.server.task_executor as j_te
from presto1_tpu_torch.server.resource_groups import (QueryQueueFull,
                                                      ResourceGroupManager)
from presto1_tpu_torch.server.task_executor import FairTaskExecutor, level_of

torch.set_num_threads(1)

CONFIG = {
    "groups": [{
        "name": "global", "hardConcurrencyLimit": 2, "maxQueued": 10,
        "subGroups": [
            {"name": "etl", "hardConcurrencyLimit": 1, "maxQueued": 2},
            {"name": "adhoc", "subGroups": [
                {"name": "${USER}", "hardConcurrencyLimit": 2,
                 "maxQueued": 5}]},
        ],
    }],
    "selectors": [
        {"user": "etl-.*", "group": "global.etl"},
        {"group": "global.adhoc.${USER}"},
    ],
}


def _managers():
    return ResourceGroupManager(CONFIG), j_rg.ResourceGroupManager(CONFIG)


def test_selector_routing_and_templates():
    m, ref = _managers()
    for user in ("etl-nightly", "alice", "bob", "etl-", ""):
        assert m.select(user).path == ref.select(user).path, user
    assert m.select("etl-nightly").path == "global.etl"
    g = m.select("alice")
    assert g.path == "global.adhoc.alice"  # templated leaf, per user
    assert g.hard_concurrency_limit == 2   # inherited from the template
    assert m.select("alice") is g
    assert m.select("bob") is not g


class _Sync:
    """Deterministic executor: runs thunks on demand."""

    def __init__(self):
        self.pending = []

    def __call__(self, thunk):
        self.pending.append(thunk)

    def run_one(self):
        self.pending.pop(0)()


def _trace(m, full_error, users):
    """Submit one query per user, then run every admitted thunk in turn:
    the order they ran in, the rejected submissions, and the group info
    after the submissions."""
    ex, order, rejected = _Sync(), [], []
    for i, user in enumerate(users):
        try:
            m.submit(user, None, lambda i=i: order.append(i), ex)
        except full_error:
            rejected.append(i)
    info = m.info()
    while ex.pending:
        ex.run_one()
    return order, rejected, info


@pytest.mark.parametrize("users", [
    ["etl-a"] * 4,
    ["alice", "bob", "carol"],
    ["etl-a", "alice", "etl-b", "bob", "alice", "carol", "etl-c", "dave"],
    ["alice"] * 9,
], ids=["etl_queue_full", "parent_gates", "mixed", "one_user"])
def test_admission_matches_reference(users):
    m, ref = _managers()
    assert _trace(m, QueryQueueFull, users) == \
        _trace(ref, j_rg.QueryQueueFull, users)


def test_hard_limit_queues_then_dequeues():
    m, _ = _managers()
    ex = _Sync()
    order = []
    for i in range(3):
        m.submit("etl-a", None, lambda i=i: order.append(i), ex)
    with pytest.raises(QueryQueueFull):
        m.submit("etl-a", None, lambda: order.append(99), ex)
    assert len(ex.pending) == 1
    ex.run_one()
    assert order == [0] and len(ex.pending) == 1
    ex.run_one()
    assert order == [0, 1]
    ex.run_one()
    assert order == [0, 1, 2]


def test_parent_limit_gates_children():
    m, _ = _managers()
    ex = _Sync()
    ran = []
    m.submit("alice", None, lambda: ran.append("a"), ex)
    m.submit("bob", None, lambda: ran.append("b"), ex)
    m.submit("carol", None, lambda: ran.append("c"), ex)
    assert len(ex.pending) == 2
    info = m.info()
    assert info["groups"][0]["running"] == 2
    assert info["groups"][0]["queued"] == 1
    ex.run_one()
    assert len(ex.pending) == 2
    ex.run_one()
    ex.run_one()
    assert sorted(ran) == ["a", "b", "c"]


def test_coordinator_wires_resource_groups():
    from presto1_tpu_torch.exec.catalog import TpchCatalog
    from presto1_tpu_torch.exec.engine import Engine
    from presto1_tpu_torch.exec.session import Session
    from presto1_tpu_torch.server.coordinator import QueryManager

    qm = QueryManager(Engine(TpchCatalog(sf=0.001, device="cpu"),
                             device="cpu"), max_concurrency=2)
    q = qm.submit("select 1 x", Session(user="alice"))
    deadline = time.time() + 60
    while q.state in ("QUEUED", "RUNNING") and time.time() < deadline:
        time.sleep(0.02)
    assert q.state == "FINISHED", q.error
    assert q.rows == [[1]]
    assert q.resource_group == "global"
    deadline = time.time() + 10
    while time.time() < deadline:
        if qm.resource_groups.info()["groups"][0]["running"] == 0:
            break
        time.sleep(0.02)
    assert qm.resource_groups.info()["groups"][0]["running"] == 0
    qm.pool.shutdown(wait=True)


# ------------------------------------------------------------ task executor


@pytest.mark.parametrize("seconds", [0.0, 0.5, 0.999, 1.0, 1.5, 9.99, 10.0,
                                     30.0, 59.9, 60.0, 100.0, 299.0, 300.0,
                                     1000.0])
def test_levels_match_reference(seconds):
    assert level_of(seconds) == j_te.level_of(seconds)


def test_levels_match_reference_thresholds():
    assert [level_of(s) for s in (0.0, 0.5, 1.5, 30.0, 100.0, 1000.0)] == \
        [0, 0, 1, 2, 3, 4]


def test_fresh_query_overtakes_heavy_one():
    """With one runner busy, a heavy query's queued fragment yields to a
    fresh query that arrives later (lower level wins)."""
    ex = FairTaskExecutor(concurrency=1)
    try:
        ex.run("heavy", lambda: time.sleep(0.05))
        with ex._lock:
            ex._acc["heavy"] = 30.0  # level 2

        order = []
        release = threading.Event()
        started = threading.Event()

        def blocker():
            started.set()
            release.wait(5)

        t0 = threading.Thread(target=lambda: ex.run("warmup", blocker))
        t0.start()
        started.wait(5)

        ts = []
        for q, name in (("heavy", "heavy1"), ("fresh", "fresh1"),
                        ("heavy", "heavy2")):
            t = threading.Thread(
                target=lambda q=q, name=name: ex.run(
                    q, lambda: order.append(name)))
            t.start()
            ts.append(t)
        time.sleep(0.2)
        release.set()
        for t in ts:
            t.join(5)
        t0.join(5)
        assert order[0] == "fresh1", order
    finally:
        ex.stop()


def test_errors_propagate_and_accounting_accumulates():
    ex = FairTaskExecutor(concurrency=2)
    try:
        with pytest.raises(ValueError):
            ex.run("q", lambda: (_ for _ in ()).throw(ValueError("boom")))
        ex.run("q", lambda: time.sleep(0.02))
        assert ex.accumulated("q") > 0.0
    finally:
        ex.stop()
