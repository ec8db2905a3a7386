"""Result readback: the self ms of the ``to_host`` span of
``RecordBatch.to_pylist``, per query, its waits for the column copies left
out (the conversion to Python values), over the program's traced replay
(``_program_trace.py``)."""

from . import _program_trace


def read(run):
    found = _program_trace.of(run)
    return None if found is None else found["to_host_ms_per_query"]
