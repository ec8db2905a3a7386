"""Exchange: the compressed MB (1e6 bytes) of the pages the workers made,
per query (the ``bytes`` of their ``pages_encode`` spans: for other workers
and for the coordinator), over the cluster's traced replay
(``_cluster_trace.py``)."""

from . import _cluster_trace


def read(run):
    return _cluster_trace.value(run, "exchange_mb_per_query")
