"""Workers: the self ms of the executor's spans inside the workers' tasks
(``run``, ``fragment``, ``op:*`` and the device waits), per query, summed
over the tasks, over the cluster's traced replay (``_cluster_trace.py``)."""

from . import _cluster_trace


def read(run):
    return _cluster_trace.value(run, "worker_compute_ms_per_query")
