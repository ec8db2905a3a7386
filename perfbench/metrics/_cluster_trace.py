"""The cluster's own trace of the traced queries, shared by the readers of
its program-span metrics (``pages_ms_per_query``, ``exchange_mb_per_query``,
``worker_compute_ms_per_query``, ``schedule_ms_per_query``).

After the window the coordinator sends the instances the device trace
covered again, through its query manager's route
(``QueryManager.execute``: ``MultiHostEngine.execute_statement`` for a
query), first paired with untraced calls for what tracing costs each
template (``_program_trace._paired``), then once each with the cluster's
tracing on.  Each statement's ``QueryTrace`` holds the coordinator's spans
and, grafted, those of its page pulls and of every task on the workers
(``presto1_tpu_torch/exec/dist_engine.py``, ``server/worker.py``).

A span's self time is the trace's own (``QueryTrace.span_self_ns``: its
duration less its children's; a grafted root's time is not its
parent's).  Per statement:

``pages_ms_per_query``
    self ms of every ``partition_output``, ``pages_encode`` and
    ``pages_decode`` span: pages made on the workers, read on the workers
    (their merge onto the device) and on the coordinator.
``exchange_mb_per_query``
    the compressed MB (1e6 bytes) of the workers' ``pages_encode`` spans:
    every page a worker made, for another worker or for the coordinator.
``worker_compute_ms_per_query``
    self ms of the executor's spans inside the workers' ``task`` spans
    (``run``, ``fragment``, ``op:*``, ``wait``): their fragments' compute,
    the device waits included.
``schedule_ms_per_query``
    self ms of the coordinator's ``stage_dag``, ``schedule``,
    ``task_create`` and ``task_wait`` spans.

Each metric is the mean over the replayed statements.  A program that keeps
no such trace gives None, and no metric of this family is read.  One line
``{"cluster_trace": ...}`` on standard error holds the rest, by template.
"""

from __future__ import annotations

import statistics
from typing import Dict, List, Optional

from .. import harness
from . import _program_trace

PAGES = ("partition_output", "pages_encode", "pages_decode")
COMPUTE = ("run", "fragment", "wait")
SCHEDULE = ("stage_dag", "schedule", "task_create", "task_wait")


class Statements:
    """The coordinator's route for a statement, as the query manager runs
    one, with the cluster's tracing as the engine's ``trace``."""

    def __init__(self, manager):
        self.manager = manager

    @property
    def trace(self) -> bool:
        return self.manager.cluster.trace

    @trace.setter
    def trace(self, on: bool) -> None:
        self.manager.cluster.trace = on

    def sql(self, text: str):
        return self.manager.execute(text, self.manager.engine.session.user)


def value(run, name: str):
    """The metric ``name`` of the run's replay, or None."""
    found = getattr(run, "_program_trace", None)
    return None if not found else found.get(name)


def measure(manager, insts) -> Optional[dict]:
    """The metrics over ``insts`` replayed on ``manager``'s route; None
    where it has no cluster, or its statements keep no trace."""
    cluster = getattr(manager, "cluster", None)
    if cluster is None or not hasattr(cluster, "trace") or not insts:
        return None
    route = Statements(manager)
    try:
        cost = _program_trace._paired(route, insts)
        route.trace = True
        per, names = [], []
        for inst in insts:
            try:
                out = route.sql(inst.text)
                out.to_pylist()
            except Exception as e:  # counted by the window already
                harness.log(cluster_trace_query_failed=inst.name,
                            error=repr(e))
                continue
            trace = getattr(out, "trace", None)
            if trace is None:
                return None
            per.append(statement(trace))
            names.append(inst.name)
    finally:
        route.trace = False
    if not per:
        return None
    metrics = {k: statistics.fmean(p["metrics"][k] for p in per)
               for k in per[0]["metrics"]}
    harness.log(cluster_trace={
        "queries": len(per), "metrics": metrics, "tracing_cost": cost,
        "templates": {
            name: {"queries": names.count(name),
                   "metrics": _mean([p["metrics"] for p, n in zip(per, names)
                                     if n == name]),
                   "self_ms": _mean([p["self_ms"] for p, n in zip(per, names)
                                     if n == name])}
            for name in sorted(set(names))}})
    return metrics


def _mean(dicts: List[dict]) -> dict:
    keys = sorted({k for d in dicts for k in d})
    return {k: sum(d.get(k, 0.0) for d in dicts) / len(dicts) for k in keys}


def on_workers(spans, grafted) -> List[bool]:
    """Whether each span ran on a worker: a grafted ``task`` root and what
    lies under it (a parent comes before its children)."""
    out: List[bool] = []
    for i, s in enumerate(spans):
        if i in grafted:
            out.append(s[0] == "task")
        else:
            out.append(s[3] is not None and out[s[3]])
    return out


def statement(trace) -> dict:
    """One statement's metrics, and its self ms by span name (a worker's
    spans under ``worker:<name>``)."""
    spans = trace.spans
    own = trace.span_self_ns()
    remote = on_workers(spans, trace.grafted)
    self_ms: Dict[str, float] = {}
    pages = compute = schedule = 0
    encoded = 0
    for s, ns, w in zip(spans, own, remote):
        name = s[0]
        key = f"worker:{name}" if w else name
        self_ms[key] = self_ms.get(key, 0.0) + ns / 1e6
        if name in PAGES:
            pages += ns
        if w and (name in COMPUTE or name.startswith("op:")):
            compute += ns
        if not w and name in SCHEDULE:
            schedule += ns
        if w and name == "pages_encode" and isinstance(s[4], dict):
            encoded += s[4].get("bytes", 0)
    metrics = {"pages_ms_per_query": pages / 1e6,
               "exchange_mb_per_query": encoded / 1e6,
               "worker_compute_ms_per_query": compute / 1e6,
               "schedule_ms_per_query": schedule / 1e6}
    return {"metrics": metrics, "self_ms": self_ms}
