"""Fair task execution: a multilevel feedback queue over query CPU time.

The reference time-slices splits with 1 s quanta and demotes
long-running queries through a 5-level queue
(``execution/executor/TaskExecutor.java:308,484``,
``MultilevelSplitQueue.java:43`` — LEVEL_THRESHOLD_SECONDS
{0,1,10,60,300}).  Here the atomic unit is a FRAGMENT's compute phase
(one fragment's operators are enqueued on the device's stream together, so
there is nothing to preempt inside it); fairness applies between queries at
fragment granularity:

* each query accumulates the wall time its fragments have consumed;
* the accumulated time maps to a level (same thresholds as the
  reference); runnable fragments order by (level, in-level accumulated
  time, arrival) — a fresh interactive query always overtakes the
  batch query that has been burning CPU for minutes;
* a bounded runner pool executes them; the exchange FETCH phase stays
  on the task's own thread (a blocked fetch must never occupy a
  runner — the Driver-blocked-future analog).
"""

from __future__ import annotations

import heapq
import os
import threading
import time
from typing import Dict, Optional

LEVEL_THRESHOLD_SECONDS = (0.0, 1.0, 10.0, 60.0, 300.0)


def level_of(accumulated_s: float) -> int:
    lvl = 0
    for i, t in enumerate(LEVEL_THRESHOLD_SECONDS):
        if accumulated_s >= t:
            lvl = i
    return lvl


class FairTaskExecutor:
    def __init__(self, concurrency: Optional[int] = None):
        if concurrency is None:
            concurrency = int(os.environ.get(
                "P1_TASK_CONCURRENCY", str(max(os.cpu_count() or 2, 2))))
        self.concurrency = max(int(concurrency), 1)
        self._acc: Dict[str, float] = {}     # query -> accumulated wall s
        self._lock = threading.Lock()
        self._queue: list = []               # (level, acc, seq, entry)
        self._seq = 0
        self._cv = threading.Condition(self._lock)
        self._shutdown = False
        self._threads = [
            threading.Thread(target=self._loop, daemon=True,
                             name=f"task-runner-{i}")
            for i in range(self.concurrency)
        ]
        for t in self._threads:
            t.start()

    # -- public API ------------------------------------------------------

    def run(self, query_id: str, fn):
        """Execute ``fn`` under fair scheduling and return its result
        (blocks the calling task thread until done — the caller is the
        task's own fetch/serve thread, never a runner)."""
        entry = {"fn": fn, "query": query_id or "?",
                 "done": threading.Event(), "out": None, "err": None}
        with self._cv:
            acc = self._acc.get(entry["query"], 0.0)
            heapq.heappush(self._queue,
                           (level_of(acc), acc, self._seq, entry))
            self._seq += 1
            self._cv.notify()
        entry["done"].wait()
        if entry["err"] is not None:
            raise entry["err"]
        return entry["out"]

    def accumulated(self, query_id: str) -> float:
        with self._lock:
            return self._acc.get(query_id, 0.0)

    def stop(self) -> None:
        """Stop the runners once the queue is empty, and wait for them
        (bounded)."""
        with self._cv:
            self._shutdown = True
            self._cv.notify_all()
        for t in self._threads:
            if t is not threading.current_thread():
                t.join(timeout=10)

    # -- runner loop -----------------------------------------------------

    def _loop(self) -> None:
        while True:
            with self._cv:
                while not self._queue and not self._shutdown:
                    self._cv.wait()
                if self._shutdown and not self._queue:
                    return
                _, _, _, entry = heapq.heappop(self._queue)
            t0 = time.time()
            try:
                entry["out"] = entry["fn"]()
            except BaseException as e:  # noqa: BLE001 — relayed to caller
                entry["err"] = e
            finally:
                dt = time.time() - t0
                with self._lock:
                    q = entry["query"]
                    self._acc[q] = self._acc.get(q, 0.0) + dt
                    if len(self._acc) > 4096:  # bound the ledger
                        for k in list(self._acc)[:2048]:
                            del self._acc[k]
                entry["done"].set()
