"""Exchange: the self ms of the pages' spans, per query: the workers'
``partition_output`` and ``pages_encode`` (hashing rows to their buffers,
serializing and compressing them) and every ``pages_decode`` (the workers'
and the coordinator's reads of the pages they pulled), over the cluster's
traced replay (``_cluster_trace.py``)."""

from . import _cluster_trace


def read(run):
    return _cluster_trace.value(run, "pages_ms_per_query")
