"""Executor: CUDA kernels the traced queries enqueued, per query (memcpy
and memset events are not kernels)."""


def read(run):
    return run.trace.kernels / run.trace.queries if run.trace.kernels \
        else None
