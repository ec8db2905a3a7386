"""Coordinator: the self ms of its scheduling spans, per query
(``stage_dag``, ``schedule``, ``task_create``, ``task_wait``: cutting the
plan into stages, creating their tasks on the workers and reading the
tasks' status), over the cluster's traced replay (``_cluster_trace.py``)."""

from . import _cluster_trace


def read(run):
    return _cluster_trace.value(run, "schedule_ms_per_query")
