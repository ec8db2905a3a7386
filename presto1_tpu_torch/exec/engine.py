"""Engine facade: SQL in, decoded results out.

The single-node analog of the reference's LocalQueryRunner
(``core/trino-main/.../testing/LocalQueryRunner.java``): wires parser ->
planner -> optimizer -> executor over a catalog with no server in between,
plus the query-lifecycle plumbing (sessions, events).

The port carries ``plan``, ``explain``, ``explain_analyze``, ``sql`` (with
per-query memory accounting and spilling), ``sql_pandas``, ``compile`` (with
sampled discovery), ``compile_grouped`` and ``execute_statement``: EXPLAIN
[ANALYZE], CREATE TABLE [AS], INSERT (a query or VALUES), DROP TABLE and
SHOW / DESCRIBE over writable memory tables (``exec/memory_catalog.py``),
with the system tables (``exec/system_catalog.py``) attached to the catalog
and plan-time access control (``server/security.py``).  The query of a
CREATE TABLE AS or an INSERT runs under the same memory limit and spill
threshold as ``sql`` (the JAX package runs it unbounded: ROADMAP C10), and
VALUES decimals are parsed from their text exactly (C9).
``sql_distributed`` waits for ROADMAP A11.
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
                 access_control=None, device="cuda"):
        self.catalog = catalog
        self.session = session or Session()
        self.events = events or EventBus()
        self.memory_pool = memory_pool  # shared MemoryPool (optional)
        self.access_control = access_control  # server/security.AccessControl
        # where every query of this engine runs, and where the tables it
        # creates live; nothing looks for another device when this one is
        # missing
        self.device = torch.device(device)
        self._compiled_cache: dict = {}
        from .system_catalog import attach_system_tables

        attach_system_tables(self.catalog, self)

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

    def _enforce_access(self, plan: LogicalNode, user: Optional[str]) -> None:
        """Plan-time access control on resolved Scan nodes, fail-closed.

        The reference checks table privileges during semantic analysis on
        resolved table handles (``security/AccessControlManager``,
        ``sql/analyzer/StatementAnalyzer``); checking the optimized plan's
        Scan set covers every reference -- FROM clauses, subqueries in any
        clause, CTEs -- because all of them lower to Scans."""
        acl = self.access_control
        if acl is None:
            return
        for table in self.scan_tables(plan):
            acl.check_can_select(user or self.session.user,
                                 self.session.catalog, table)

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
        plan = optimize(Planner(self.catalog).plan(q), self.catalog)
        self._enforce_access(plan, user)
        return plan

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
                if self.access_control is not None:
                    # re-check per call: the cache is shared across users
                    for t in cq.scan_tables:
                        self.access_control.check_can_select(
                            user or self.session.user,
                            self.session.catalog, t)
                out = cq()
            else:
                out = self._execute(self.plan(sql, user=user), stats)
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

    def _execute(self, plan: LogicalNode,
                 stats: Optional[QueryStats] = None):
        """Run a plan eagerly under the session's memory limit and spill
        threshold (``query_max_memory``, ``spill_threshold``)."""
        mem = self._memory_context()
        try:
            ex = Executor(
                self.catalog, stats=stats, device=self.device, memory=mem,
                dynamic_filtering=self.session.get(
                    "enable_dynamic_filtering"),
                spill_threshold=(
                    self.session.get("spill_threshold")
                    if self.session.get("spill_enabled") else 0))
            out = ex.execute(plan)
            # eager-mode guards (wide-decimal sum overflow): the compiled
            # path ANDs these into its one readback
            for chk in ex.overflow_checks:
                if not bool(chk):
                    raise ArithmeticError(
                        "aggregate overflow: a decimal sum exceeded the "
                        "18-digit device decimal (reference raises on "
                        "decimal(38) overflow too) -- cast to double or "
                        "reduce the scale")
            return out
        finally:
            if mem is not None:
                mem.release_all()
                if self.memory_pool is not None:
                    self.memory_pool.unregister(mem)

    def sql_pandas(self, sql: str):
        return self.sql(sql).to_pandas()

    def execute_statement(self, sql: str, user: Optional[str] = None,
                          stats: Optional[QueryStats] = None):
        """Full statement surface: queries plus CREATE TABLE [AS] /
        INSERT INTO (query or VALUES) / DROP TABLE against writable
        in-memory tables on this engine's device (the trino-memory
        connector analog), EXPLAIN [ANALYZE] and SHOW / DESCRIBE.

        ``stats`` collects per-operator attribution for a query, and for
        the query of a CREATE TABLE AS or an INSERT, on the eager path (the
        compiled path ignores it -- its attribution lives in
        ``CompiledQuery.profile``)."""
        from ..sql import ast
        from ..sql.parser import parse_statement
        from ..sql.planner import parse_type
        from .memory_catalog import MemoryTable

        stmt = parse_statement(sql)
        if isinstance(stmt, ast.Explain):
            if stmt.analyze:
                inner = sql[sql.lower().index("analyze") + len("analyze"):]
                text = self.explain_analyze(inner, user=user)
            else:
                inner = sql[sql.lower().index("explain") + len("explain"):]
                text = plan_tree(self.plan(inner, user=user))
            return self._strings({"plan": text.split("\n")}, width="U")
        if isinstance(stmt, ast.Query):
            return self.sql(sql, stats=stats, user=user)
        if isinstance(stmt, ast.CreateTable):
            if stmt.name in self.catalog:
                raise ValueError(f"table {stmt.name} already exists")
            if stmt.columns is not None:
                schema = [(c, parse_type(t)) for c, t in stmt.columns]
                self.catalog.tables[stmt.name] = MemoryTable(
                    stmt.name, schema, device=self.device)
                return self._dml_result(0)
            out = self._execute(self._plan_ast(stmt.as_query, user), stats)
            schema = [(n, c.type) for n, c in out.columns.items()]
            table = MemoryTable(stmt.name, schema, device=self.device)
            n = table.append(out)
            self.catalog.tables[stmt.name] = table
            return self._dml_result(n)
        if isinstance(stmt, ast.DropTable):
            if stmt.name not in self.catalog:
                raise ValueError(f"table {stmt.name} not found")
            del self.catalog.tables[stmt.name]
            return self._dml_result(0)
        if isinstance(stmt, ast.InsertInto):
            # write through the connector page sink (ConnectorPageSink):
            # rows buffer invisibly and commit atomically at finish() --
            # a failing INSERT ... SELECT leaves the table untouched
            table = self.catalog.table(stmt.name)
            if not hasattr(table, "page_sink"):
                raise ValueError(f"table {stmt.name} is not writable")
            sink = table.page_sink()
            try:
                if stmt.query is not None:
                    out = self._execute(self._plan_ast(stmt.query, user),
                                        stats)
                else:
                    out = self._values_batch(stmt.values, table)
                sink.append(out)
            except Exception:
                sink.abort()
                raise
            return self._dml_result(sink.finish())
        if isinstance(stmt, ast.Show):
            return self._show(stmt)
        raise ValueError(f"unsupported statement {type(stmt).__name__}")

    def _strings(self, cols: dict, width: str = "U64"):
        """A batch of varchar columns on this engine's device (``width``:
        the numpy string dtype the values pass through)."""
        import numpy as np

        from ..batch import from_numpy
        from ..types import VARCHAR

        arrays = {k: np.asarray(v, dtype=width) for k, v in cols.items()}
        return from_numpy(arrays, {k: VARCHAR for k in cols},
                          device=self.device)

    def _show(self, stmt):
        """SHOW TABLES/COLUMNS/SCHEMAS/CATALOGS/SESSION/FUNCTIONS +
        DESCRIBE (reference: metadata-backed SHOW rewrites in
        StatementRewrite / information_schema)."""
        def strings(**cols):
            return self._strings(cols)

        if stmt.what == "tables":
            return strings(table=sorted(self.catalog.tables))
        if stmt.what == "columns":
            t = self.catalog.table(stmt.target)
            return strings(column=list(t.schema.keys()),
                           type=[str(tt) for tt in t.schema.values()])
        if stmt.what == "schemas":
            return strings(schema=[self.session.schema])
        if stmt.what == "catalogs":
            return strings(catalog=[self.session.catalog])
        if stmt.what == "session":
            from .session import SYSTEM_SESSION_PROPERTIES as P

            names = sorted(P)
            return strings(name=names,
                           value=[str(self.session.get(n)) for n in names],
                           description=[P[n][2] for n in names])
        if stmt.what == "functions":
            from ..sql.planner import AGG_FNS, ExprConverter

            scalars = sorted(ExprConverter.SCALAR_FNS) + [
                "year", "month", "day", "quarter", "week", "day_of_week",
                "date_trunc", "date_add", "date_diff", "current_date",
                "extract", "substring", "like", "cast", "between",
            ]
            wins = ["row_number", "rank", "dense_rank", "ntile", "lag",
                    "lead", "first_value", "last_value", "nth_value"]
            names = ([(f, "scalar") for f in scalars]
                     + [(f, "aggregate") for f in sorted(AGG_FNS)]
                     + [(f, "window") for f in wins])
            return strings(function=[n for n, _ in names],
                           kind=[k for _, k in names])
        raise ValueError(f"SHOW {stmt.what} unsupported")

    def _dml_result(self, rows: int):
        from ..batch import Column, RecordBatch
        from ..types import BIGINT

        return RecordBatch(
            {"rows": Column(torch.full((1,), rows, dtype=torch.int64,
                                       device=self.device), BIGINT)}, 1)

    def _values_batch(self, rows, table):
        """The literal rows of ``INSERT ... VALUES`` as a batch of the
        table's types.  A decimal literal is scaled from its text exactly
        (``1234567890123456.78`` is the unscaled 123456789012345678;
        the JAX package goes through a float64: ROADMAP C9), rounding half
        away from zero past the column's scale."""
        from decimal import ROUND_HALF_UP, Decimal

        import numpy as np

        from ..batch import from_numpy
        from ..sql import ast

        cols = {c: [] for c in table.column_order}
        for row in rows:
            if len(row) != len(table.column_order):
                raise ValueError("VALUES arity mismatch")
            for cname, e in zip(table.column_order, row):
                t = table.schema[cname]
                neg = False
                while isinstance(e, ast.UnaryOp) and e.op == "-":
                    neg = not neg
                    e = e.operand
                if isinstance(e, ast.NumberLit):
                    if t.kind == "decimal":
                        v = int((Decimal(e.text).scaleb(t.scale)).quantize(
                            Decimal(1), rounding=ROUND_HALF_UP))
                    else:
                        v = float(e.text) if "." in e.text else int(e.text)
                elif isinstance(e, ast.StringLit):
                    v = e.value
                elif isinstance(e, ast.DateLit):
                    v = np.datetime64(e.value, "D")
                elif isinstance(e, ast.TimestampLit):
                    v = np.datetime64(e.value.replace(" ", "T", 1), "us")
                else:
                    raise ValueError("VALUES must be literals")
                if neg:
                    v = -v
                cols[cname].append(v)
        arrays = {}
        for cname in table.column_order:
            t = table.schema[cname]
            vals = cols[cname]
            if t.is_string:
                arrays[cname] = np.asarray(vals, dtype=object)
            elif t.kind == "decimal":
                arrays[cname] = np.asarray(vals, dtype=np.int64)
            elif t.kind == "date":
                arrays[cname] = (
                    np.asarray(vals, dtype="datetime64[D]")
                    - np.datetime64("1970-01-01", "D")).astype(np.int32)
            elif t.kind == "timestamp":
                arrays[cname] = (
                    np.asarray(vals, dtype="datetime64[us]")
                    - np.datetime64("1970-01-01T00:00:00", "us")
                ).astype(np.int64)
            else:
                arrays[cname] = np.asarray(vals).astype(t.np_dtype)
        return from_numpy(arrays, dict(table.schema), device=self.device)

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
