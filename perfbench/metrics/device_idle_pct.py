"""Device: the share of the traced window in which nothing ran on the
device, 100 x (1 - busy / wall).  The wall is the host's clock around the
traced queries, which the profiler slows little since it traces the device
alone."""


def read(run):
    if run.trace.busy_s <= 0:
        return None
    return 100.0 * (1.0 - run.trace.busy_s / run.trace.window_s)
