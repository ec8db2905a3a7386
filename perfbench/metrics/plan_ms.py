"""Frontend and planner: the mean host ms of ``Engine.plan(text)`` (parse,
plan, optimise) over the window's texts, each planned three times after
the window has closed."""

import time

REPS = 3


def read(run):
    if not run.texts:
        return None
    walls = []
    for text in run.texts:
        for _ in range(REPS):
            t0 = time.perf_counter()
            run.engine.plan(text)
            walls.append(time.perf_counter() - t0)
    return 1e3 * sum(walls) / len(walls)
