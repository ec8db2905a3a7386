"""Operators and kernels: the union of the device's busy intervals over
the traced queries, in ms per query."""


def read(run):
    return run.trace.busy_s * 1e3 / run.trace.queries \
        if run.trace.busy_s > 0 else None
