"""Per-operator execution statistics and EXPLAIN ANALYZE.

The analog of the reference's OperatorStats → … → QueryStats rollup
(``operator/OperatorStats``, timed by ``operator/OperationTimer``) and its
EXPLAIN ANALYZE rendering (``operator/ExplainAnalyzeOperator.java:34``,
``sql/planner/planprinter/``).  Eager mode times each operator around its
device sync; compiled mode enqueues a fragment's ops without waiting for
the device, so per-op time there is a profiler concern (``torch.profiler``).
"""

from __future__ import annotations

import threading
import time
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple


@dataclass
class OperatorStats:
    name: str
    detail: str = ""
    wall_s: float = 0.0
    output_rows: int = 0
    invocations: int = 0
    # a spilled operator's partition count and bytes moved over PCIe
    # (``Executor._spill_done``)
    spill: Optional[dict] = None


@dataclass
class QueryStats:
    """Stats tree keyed by plan-node path.

    ``record`` (the executing thread) and ``items`` / ``snapshot`` (a
    reader on another thread, such as the coordinator's HTTP handler while
    the query runs) hold ``lock``, so a reader never iterates the tree while
    an operator is inserted.  A caller may pass its own lock (the
    coordinator passes the query's)."""

    operators: Dict[Tuple[int, ...], OperatorStats] = field(default_factory=dict)
    wall_s: float = 0.0
    peak_capacity_rows: int = 0
    lock: threading.Lock = field(default_factory=threading.Lock,
                                 repr=False, compare=False)

    def record(self, path, name, detail, wall_s, output_rows, capacity,
               spill=None):
        with self.lock:
            op = self.operators.setdefault(path, OperatorStats(name, detail))
            op.wall_s += wall_s
            op.output_rows = output_rows
            op.invocations += 1
            if spill is not None:
                op.spill = dict(spill)
                op.detail = (f"spilled: {spill['partitions']} partitions, "
                             f"{spill['to_host_bytes'] / 1e6:.1f} MB to "
                             f"host, {spill['from_host_bytes'] / 1e6:.1f} "
                             f"MB back")
            self.peak_capacity_rows = max(self.peak_capacity_rows, capacity)

    def items(self) -> List[Tuple[Tuple[int, ...], OperatorStats]]:
        """The operators by path, sorted, copied under the lock."""
        with self.lock:
            return sorted(((path, OperatorStats(**vars(op)))
                           for path, op in self.operators.items()),
                          key=lambda kv: kv[0])

    def snapshot(self) -> "QueryStats":
        """A copy of the tree taken under the lock (to render while the
        query still runs)."""
        ops = dict(self.items())
        with self.lock:
            return QueryStats(ops, self.wall_s, self.peak_capacity_rows)

    def render(self, plan) -> str:
        lines: List[str] = [f"Query: {self.wall_s * 1000:.1f} ms total"]
        self._render(plan, (), 0, lines)
        return "\n".join(lines)

    def _render(self, node, path, indent, lines):
        from ..sql.logical import plan_tree

        op = self.operators.get(path)
        head = plan_tree(node, 0).split("\n")[0]
        pad = "  " * indent
        if op is not None:
            extra = f", {op.detail}" if op.detail else ""
            lines.append(
                f"{pad}{head}   [{op.wall_s * 1000:.1f} ms, "
                f"{op.output_rows} rows{extra}]")
        else:
            lines.append(f"{pad}{head}")
        for i, child in enumerate(node.children):
            self._render(child, path + (i,), indent + 1, lines)


class Timer:
    def __init__(self):
        self.t0 = time.time()

    def stop(self) -> float:
        return time.time() - self.t0
