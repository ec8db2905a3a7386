"""Engine facade: SQL in, decoded results out.

The single-node analog of the reference's LocalQueryRunner
(``core/trino-main/.../testing/LocalQueryRunner.java``): wires parser ->
planner -> optimizer -> executor over a catalog with no server in between,
plus the query-lifecycle plumbing (sessions, events).

This slice of the port carries ``plan``, ``explain``, ``explain_analyze``,
``sql`` (with per-query memory accounting and spilling), ``sql_pandas``,
``compile`` (with sampled discovery) and ``compile_grouped``.  System tables
(``attach_system_tables``) and the statement surface beyond queries wait for
ROADMAP A10, access control for A12, ``sql_distributed`` for A11.
"""

from __future__ import annotations

import time
from typing import Optional

import torch

from ..sql import parser as sql_parser
from ..sql.logical import LogicalNode, plan_tree
from ..sql.optimizer import optimize
from ..sql.planner import Planner
from .catalog import Catalog
from .events import EventBus, QueryEvent
from .executor import Executor
from .session import Session
from .stats import QueryStats


class Engine:
    def __init__(self, catalog: Catalog, session: Optional[Session] = None,
                 events: Optional[EventBus] = None, memory_pool=None,
                 device="cuda"):
        self.catalog = catalog
        self.session = session or Session()
        self.events = events or EventBus()
        self.memory_pool = memory_pool  # shared MemoryPool (optional)
        # where every query of this engine runs; nothing looks for another
        # device when this one is missing
        self.device = torch.device(device)
        self._compiled_cache: dict = {}

    def _memory_context(self):
        """Per-query accounting when a limit or shared pool is configured."""
        limit = self.session.get("query_max_memory")
        if not limit and self.memory_pool is None:
            return None
        from .memory import QueryMemoryContext

        ctx = QueryMemoryContext(self.session.query_id,
                                 max_bytes=limit or None,
                                 pool=self.memory_pool)
        if self.memory_pool is not None:
            self.memory_pool.register(ctx)
        return ctx

    def scan_tables(self, plan: LogicalNode) -> list:
        from ..sql.logical import Scan

        out, stack = [], [plan]
        while stack:
            node = stack.pop()
            if isinstance(node, Scan):
                out.append(node.table)
            stack.extend(node.children)
        return out

    def _plan_ast(self, q, user: Optional[str] = None) -> LogicalNode:
        return optimize(Planner(self.catalog).plan(q), self.catalog)

    def plan(self, sql: str, user: Optional[str] = None) -> LogicalNode:
        return self._plan_ast(sql_parser.parse(sql), user)

    def explain(self, sql: str) -> str:
        return plan_tree(self.plan(sql))

    def sql(self, sql: str, stats: Optional[QueryStats] = None,
            user: Optional[str] = None):
        """Execute; returns the Output RecordBatch (display-named columns).

        A fresh Executor per statement: capacity/range records are
        plan-specific (sharing them across different plans would corrupt
        shapes)."""
        self.events.emit(QueryEvent("created", self.session.query_id, sql,
                                    self.session.user))
        t0 = time.time()
        try:
            if self.session.get("compile_queries") and stats is None:
                # plan-cache path (the reference caches plans per query
                # shape; here the cached artifact is the compiled fragments)
                cq = self._compiled_cache.get(sql)
                if cq is None:
                    cq = self.compile(sql, user=user)
                    self._compiled_cache[sql] = cq
                out = cq()
            else:
                plan = self.plan(sql, user=user)
                mem = self._memory_context()
                try:
                    ex = Executor(
                        self.catalog, stats=stats, device=self.device,
                        memory=mem,
                        dynamic_filtering=self.session.get(
                            "enable_dynamic_filtering"),
                        spill_threshold=(
                            self.session.get("spill_threshold")
                            if self.session.get("spill_enabled") else 0))
                    out = ex.execute(plan)
                    # eager-mode guards (wide-decimal sum overflow): the
                    # compiled path ANDs these into its one readback
                    for chk in ex.overflow_checks:
                        if not bool(chk):
                            raise ArithmeticError(
                                "aggregate overflow: a decimal sum "
                                "exceeded the 18-digit device decimal "
                                "(reference raises on decimal(38) "
                                "overflow too) -- cast to double or "
                                "reduce the scale")
                finally:
                    if mem is not None:
                        mem.release_all()
                        if self.memory_pool is not None:
                            self.memory_pool.unregister(mem)
            rows = out.num_rows if isinstance(out.num_rows, int) \
                else int(out.num_rows)
        except Exception as e:
            from .metrics import REGISTRY

            REGISTRY.counter("engine.queries_failed").update()
            self.events.emit(QueryEvent(
                "failed", self.session.query_id, sql, self.session.user,
                wall_s=time.time() - t0, error=str(e)))
            raise
        from .metrics import REGISTRY

        REGISTRY.counter("engine.queries_completed").update()
        REGISTRY.counter("engine.output_rows").update(rows)
        REGISTRY.distribution("engine.query_wall_s").add(time.time() - t0)
        self.events.emit(QueryEvent(
            "completed", self.session.query_id, sql, self.session.user,
            wall_s=time.time() - t0, rows=rows))
        if stats is not None:
            stats.wall_s = time.time() - t0
        return out

    def sql_pandas(self, sql: str):
        return self.sql(sql).to_pandas()

    def explain_analyze(self, sql: str, user: Optional[str] = None) -> str:
        """EXPLAIN ANALYZE: per-operator timings.

        With ``compile_queries`` on, the numbers come from the compiled
        path -- per-fragment steady-state walls, rows and bytes from
        ``CompiledQuery.profile()`` (CUDA events on a CUDA device),
        annotated onto the fragment-root plan nodes.  Eager sessions keep
        the per-operator tree of ``QueryStats`` (host clock around each
        operator, which ends in its row count's readback)."""
        if self.session.get("compile_queries"):
            cq = self._compiled_cache.get(sql)
            if cq is None:
                cq = self.compile(sql, user=user)
                self._compiled_cache[sql] = cq
            t0 = time.time()
            frags = cq.profile()
            stats = QueryStats()
            stats.wall_s = sum(w for _, w, _r, _b in frags)
            for root, wall, rows, nbytes in frags:
                stats.record(root, "Fragment", "", wall, rows, 0)
                stats.operators[root].detail = f"{nbytes / 1e6:.1f} MB out"
            text = stats.render(cq.plan)
            return text + (
                f"\n(compiled path: {len(frags)} fragments, per-fragment "
                f"steady-state walls over 5 reps; profile wall "
                f"{(time.time() - t0):.2f} s)")
        stats = QueryStats()
        plan = self.plan(sql, user=user)
        t0 = time.time()
        Executor(self.catalog, stats=stats, device=self.device).execute(plan)
        stats.wall_s = time.time() - t0
        return stats.render(plan)

    def compile(self, sql: str, user: Optional[str] = None,
                sample: object = "auto"):
        """Fix the whole query pipeline into fragment callables over
        static shapes (runs one eager discovery pass, on this engine's
        device, to fix buffer capacities).

        ``sample``: ``"auto"`` (default) prefix-samples the dominant table
        during discovery when it is large enough to matter
        (``exec/sampling.py``, sublinear discovery); ``None``/``False``
        forces full-data discovery; an explicit ``{table: k}`` dict samples
        those tables at 1/k.  Disable globally with
        ``P1_DISCOVERY_SAMPLE=0``."""
        import os

        from .executor import CompiledQuery

        plan = self.plan(sql, user=user)
        if sample == "auto":
            if os.environ.get("P1_DISCOVERY_SAMPLE", "auto") in ("0", "off"):
                sample = None
            else:
                from .sampling import choose_sample

                sample = choose_sample(self.catalog, plan)
        cq = CompiledQuery(self.catalog, plan, sample=sample or None,
                           device=self.device)
        cq.scan_tables = self.scan_tables(plan)
        return cq

    def compile_grouped(self, sql: str, n_groups: int = 4,
                        user: Optional[str] = None):
        """Compile with grouped execution: the dominant table is
        row-sharded into ``n_groups`` splits processed one at a time
        (the compiled path's spill / Lifespan analog, ``exec/grouped.py``),
        bounding peak device memory to ~2/n_groups of the scan working
        set.  Raises ValueError for a plan a shard would answer wrongly."""
        from .grouped import GroupedCompiledQuery

        return GroupedCompiledQuery(self, self.plan(sql, user=user),
                                    n_groups)
