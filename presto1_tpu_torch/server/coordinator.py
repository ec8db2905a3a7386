"""Coordinator HTTP server: the statement protocol.

A compact re-design of the reference's client protocol surface
(``dispatcher/QueuedStatementResource.java:93`` POST /v1/statement,
``server/protocol/ExecutingStatementResource.java:143`` paged GETs with
nextUri, ``server/QueryResource.java`` query info): stdlib HTTP server, a
query manager with the QUEUED→RUNNING→FINISHED/FAILED state machine
(``execution/QueryStateMachine.java``), token-paged JSON results, and
cancellation via DELETE.

This server fronts an Engine on its torch device, which runs every
statement where the coordinator also executes (Trino's single node,
``node-scheduler.include-coordinator=true``).  Given a cluster (a
``exec/dist_engine.MultiHostEngine``, ``include-coordinator=false``) it also
serves discovery (``PUT /v1/announcement/{nodeId}``, ``GET /v1/node``) and
sends each query and EXPLAIN ANALYZE there: the stage DAG runs as tasks on
the ``server/worker.py`` servers that announced themselves, and the
FINISHED page's ``stats`` count its stages, tasks, bytes and the tasks of
each node.  Every other statement (metadata, DDL, DML, a plain EXPLAIN)
runs on the local engine, as Trino's coordinator keeps them.  With the
cluster's shared secret, discovery takes only requests that carry it.

Result rows reach the wire as JSON built from numpy values
(``_json_value``); nothing on this path imports pandas.  A running query's
operator statistics are read under the query's lock (``ManagedQuery.info``
and the ``/ui`` pages take a snapshot): the JAX package iterates them
unlocked while the query inserts operators (ROADMAP C22).
"""

from __future__ import annotations

import json
import threading
import time
import traceback
import uuid
from concurrent.futures import ThreadPoolExecutor
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Dict, List, Optional

from ..exec.engine import Engine
from ..exec.session import Session

PAGE_ROWS = 1000


class QueryState:
    QUEUED = "QUEUED"
    RUNNING = "RUNNING"
    FINISHED = "FINISHED"
    FAILED = "FAILED"
    CANCELED = "CANCELED"


class ManagedQuery:
    def __init__(self, query_id: str, sql: str, session: Session):
        self.id = query_id
        self.sql = sql
        self.session = session
        self.state = QueryState.QUEUED
        self.error: Optional[str] = None
        self.columns: List[dict] = []
        self.rows: List[list] = []
        self.created = time.time()
        self.wall_s: Optional[float] = None
        self.resource_group: Optional[str] = None
        # exec.stats.QueryStats (eager-path queries); made with this
        # query's lock, which its record() and snapshots hold
        self.stats = None
        # a query that ran on the cluster: its stage and task counts
        # (MultiHostEngine.execute_statement), on the FINISHED page
        self.cluster_stats: Optional[dict] = None
        self.lock = threading.Lock()

    def info(self) -> dict:
        out = {
            "id": self.id,
            "state": self.state,
            "query": self.sql,
            "error": self.error,
            "wall_s": self.wall_s,
            "rows": len(self.rows) if self.state == QueryState.FINISHED else None,
        }
        ops = self.stats.items() if self.stats is not None else []
        if ops:
            # QueryStats tree flattened for the wire (OperatorStats
            # analog, ``operator/OperatorStats.java``), from a snapshot
            # taken under the query's lock
            out["operators"] = [
                {"path": "/".join(map(str, path)), "operator": op.name,
                 "detail": op.detail, "wall_ms": round(op.wall_s * 1000, 2),
                 "output_rows": int(op.output_rows),
                 "invocations": op.invocations}
                for path, op in ops
            ]
        return out


class QueryManager:
    """Owns query lifecycle; executes on a small pool (admission control —
    the minimal stand-in for the reference's resource groups,
    ``execution/resourcegroups/InternalResourceGroup.java:77``)."""

    def __init__(self, engine: Engine, max_concurrency: int = 4,
                 resource_groups: Optional[dict] = None, cluster=None):
        from .resource_groups import ResourceGroupManager

        self.engine = engine
        # where queries run when the coordinator does not execute them
        # (a MultiHostEngine), else None
        self.cluster = cluster
        self.queries: Dict[str, ManagedQuery] = {}
        # the pool is sized generously; per-group hard concurrency limits
        # are what actually gate admission (InternalResourceGroup)
        self.pool = ThreadPoolExecutor(max_workers=max(max_concurrency * 4,
                                                       16))
        self.resource_groups = ResourceGroupManager(
            resource_groups, default_concurrency=max_concurrency)

    def submit(self, sql: str, session: Session) -> ManagedQuery:
        from .resource_groups import QueryQueueFull

        q = ManagedQuery(uuid.uuid4().hex[:16], sql, session)
        self.queries[q.id] = q
        try:
            q.resource_group = self.resource_groups.submit(
                session.user, getattr(session, "source", None),
                lambda: self._run(q), self.pool.submit)
        except QueryQueueFull as e:
            q.error = f"QueryQueueFull: {e}"
            q.state = QueryState.FAILED
        return q

    def _run(self, q: ManagedQuery) -> None:
        with q.lock:
            if q.state == QueryState.CANCELED:
                return
            q.state = QueryState.RUNNING
        t0 = time.time()
        # access control is enforced at plan time on resolved Scan nodes
        # (Engine._enforce_access) and fails closed: a parse/plan error
        # fails the query before any table is read.
        try:
            # per-operator attribution on the eager path; the compiled
            # path keeps its cache (stats would force eager execution)
            if not self.engine.session.get("compile_queries"):
                from ..exec.stats import QueryStats

                q.stats = QueryStats(lock=q.lock)
            cluster_stats: dict = {}
            out = self.execute(q.sql, q.session.user, stats=q.stats,
                               cluster_stats=cluster_stats)
            q.cluster_stats = cluster_stats or None
            n = out.num_rows if isinstance(out.num_rows, int) else int(out.num_rows)
            decoded = {name: c.decode(n) for name, c in out.columns.items()}
            q.columns = [
                {"name": name, "type": str(c.type)}
                for name, c in out.columns.items()
            ]
            q.rows = [
                [_json_value(decoded[name][i]) for name in decoded]
                for i in range(n)
            ]
            q.wall_s = time.time() - t0
            with q.lock:
                if q.state != QueryState.CANCELED:
                    q.state = QueryState.FINISHED
        except Exception as e:  # noqa: BLE001 — reported to the client
            q.error = f"{type(e).__name__}: {e}"
            q.wall_s = time.time() - t0
            traceback.print_exc()
            with q.lock:
                q.state = QueryState.FAILED

    def execute(self, sql: str, user: Optional[str], stats=None,
                cluster_stats: Optional[dict] = None):
        """``sql`` as this coordinator runs it: where it has a cluster, the
        statement is parsed once and a query or an EXPLAIN ANALYZE
        (``MultiHostEngine.runs``) goes to the workers (its stage and task
        counts into ``cluster_stats``); any other statement, and every
        statement of a single node, runs on the local engine (``stats``: a
        QueryStats for the eager path)."""
        if self.cluster is not None:
            from ..sql.parser import parse_statement

            stmt = parse_statement(sql)
            if self.cluster.runs(stmt):
                return self.cluster.execute_statement(stmt, user=user,
                                                      stats=cluster_stats)
        return self.engine.execute_statement(sql, user=user, stats=stats)

    def cancel(self, query_id: str) -> bool:
        q = self.queries.get(query_id)
        if q is None:
            return False
        with q.lock:
            if q.state in (QueryState.QUEUED, QueryState.RUNNING):
                q.state = QueryState.CANCELED
        return True


def _json_value(v):
    import numpy as np

    if v is None:
        return None
    if isinstance(v, (np.integer,)):
        return int(v)
    if isinstance(v, (np.floating,)):
        return float(v)
    if isinstance(v, np.datetime64):
        return str(v)
    if isinstance(v, (np.str_, str)):
        return str(v)
    if isinstance(v, (np.bool_, bool)):
        return bool(v)
    return v


def _json_fallback(v):
    """json.dumps ``default``: values outside the JSON domain become
    text, exactly once, at the protocol boundary (date -> ISO-8601,
    Decimal -> plain digits, bytes -> hex) — a DATE in a result row used
    to kill the connection with no response."""
    import datetime
    import decimal

    if isinstance(v, (datetime.date, datetime.datetime)):
        return v.isoformat()
    if isinstance(v, decimal.Decimal):
        return str(v)
    if isinstance(v, (bytes, bytearray)):
        return v.hex()
    return _json_value(v)


_UI_PAGE = """<!doctype html>
<html><head><title>presto1-tpu</title><style>
body{font-family:monospace;margin:2em;background:#111;color:#ddd}
table{border-collapse:collapse}td,th{border:1px solid #444;padding:4px 10px}
th{background:#222}.FINISHED{color:#7c7}.FAILED{color:#e77}
.RUNNING{color:#7cf}.QUEUED{color:#cc7}</style>
<meta http-equiv="refresh" content="2"></head>
<body><h2>presto1-tpu coordinator</h2><table>
<tr><th>query id</th><th>state</th><th>user</th><th>wall s</th><th>sql</th></tr>
%ROWS%</table></body></html>"""

_UI_DETAIL = """<!doctype html>
<html><head><title>presto1-tpu query</title><style>
body{font-family:monospace;margin:2em;background:#111;color:#ddd}
table{border-collapse:collapse}td,th{border:1px solid #444;padding:4px 10px}
th{background:#222}.FINISHED{color:#7c7}.FAILED{color:#e77}
.RUNNING{color:#7cf}.QUEUED{color:#cc7}pre{background:#181818;padding:1em}
a{color:#9cf}</style></head>
<body><p><a href="/ui">&larr; queries</a></p>%BODY%</body></html>"""


class CoordinatorServer:
    def __init__(self, engine: Engine, host: str = "127.0.0.1", port: int = 0,
                 authenticator=None, access_control=None,
                 resource_groups: Optional[dict] = None, cluster=None):
        """authenticator/access_control: see server/security.py; None =
        allow-all (the reference's insecure default).  cluster: a
        MultiHostEngine whose registry this server fills and whose workers
        run its queries (None: the engine runs everything).  Its
        ``internal_secret`` guards discovery; an authenticator that is not
        allow-all with a cluster but no secret raises, since any process
        that reached the port could then join as a worker."""
        import copy

        from .discovery import serve_discovery
        from .security import AccessDeniedError, Authenticator

        if access_control is not None:
            # Derive a per-server Engine carrying the ACL so table access
            # is checked at plan time on resolved Scan nodes (covers FROM,
            # every subquery position, and CTEs) and fails closed — the
            # reference enforces during semantic analysis on resolved
            # handles (security/AccessControlManager, StatementAnalyzer).
            # A derived engine (shared catalog/session/events) avoids
            # mutating an engine shared with ACL-free coordinators.
            engine = Engine(engine.catalog, engine.session,
                            events=engine.events,
                            memory_pool=engine.memory_pool,
                            access_control=access_control,
                            device=engine.device)
            if cluster is not None:
                cluster = copy.copy(cluster)
                cluster.access_control = access_control
        if cluster is not None and cluster.internal_secret is None \
                and authenticator is not None \
                and type(authenticator) is not Authenticator:
            raise ValueError(
                "an authenticated coordinator with workers needs a shared "
                "secret for their announcements "
                "(internal-communication.shared-secret)")
        self.cluster = cluster
        self.manager = QueryManager(engine, resource_groups=resource_groups,
                                    cluster=cluster)
        manager = self.manager
        auth = authenticator or Authenticator()

        class Handler(BaseHTTPRequestHandler):
            protocol_version = "HTTP/1.1"

            def log_message(self, fmt, *args):  # quiet
                pass

            def _send(self, code: int, payload: dict):
                # result values outside the JSON domain ride as strings,
                # like the reference protocol's typed-text encoding
                # (client/trino-client QueryResults renders dates and
                # decimals as ISO/plain text): date, Decimal, bytes...
                body = json.dumps(payload, default=_json_fallback).encode()
                self.send_response(code)
                self.send_header("Content-Type", "application/json")
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                self.wfile.write(body)

            def do_PUT(self):
                if cluster is None or not serve_discovery(
                        cluster.registry, self, "PUT",
                        cluster.internal_secret):
                    self._send(404, {"error": "not found"})

            def do_POST(self):
                if self.path != "/v1/statement":
                    self._send(404, {"error": "not found"})
                    return
                length = int(self.headers.get("Content-Length", "0"))
                sql = self.rfile.read(length).decode()
                try:
                    user = auth.authenticate(self.headers)
                except AccessDeniedError as e:
                    self._send(401, {"error": str(e)})
                    return
                session = Session(
                    user=user,
                    schema=self.headers.get("X-Presto1-Schema", "tiny"))
                q = manager.submit(sql, session)
                payload = {
                    "id": q.id,
                    "stats": {"state": q.state},
                    "nextUri": f"/v1/statement/executing/{q.id}/0",
                }
                if q.state in (QueryState.FAILED, QueryState.CANCELED):
                    # a statement that failed before this reply says why
                    payload["error"] = {"message": q.error or q.state}
                self._send(200, payload)

            def do_GET(self):
                if cluster is not None and serve_discovery(
                        cluster.registry, self, "GET",
                        cluster.internal_secret):
                    return
                parts = self.path.strip("/").split("/")
                if parts == ["v1", "resourceGroupState"]:
                    self._send(200, manager.resource_groups.info())
                    return
                if parts[:3] == ["v1", "statement", "executing"] and len(parts) == 5:
                    qid, token = parts[3], int(parts[4])
                    q = manager.queries.get(qid)
                    if q is None:
                        self._send(404, {"error": "unknown query"})
                        return
                    if q.state in (QueryState.QUEUED, QueryState.RUNNING):
                        self._send(200, {
                            "id": q.id, "stats": {"state": q.state},
                            "nextUri": f"/v1/statement/executing/{qid}/{token}",
                        })
                        return
                    if q.state in (QueryState.FAILED, QueryState.CANCELED):
                        self._send(200, {
                            "id": q.id,
                            "stats": {"state": q.state},
                            "error": {"message": q.error or q.state},
                        })
                        return
                    start = token * PAGE_ROWS
                    page = q.rows[start:start + PAGE_ROWS]
                    payload = {
                        "id": q.id,
                        "stats": {"state": q.state, "wall_s": q.wall_s,
                                  **(q.cluster_stats or {})},
                        "columns": q.columns,
                        "data": page,
                    }
                    if start + PAGE_ROWS < len(q.rows):
                        payload["nextUri"] = (
                            f"/v1/statement/executing/{qid}/{token + 1}")
                    self._send(200, payload)
                    return
                if parts[:2] == ["v1", "query"] and len(parts) == 3:
                    q = manager.queries.get(parts[2])
                    if q is None:
                        self._send(404, {"error": "unknown query"})
                        return
                    self._send(200, q.info())
                    return
                if parts == ["v1", "info"]:
                    self._send(200, {"nodeVersion": "presto1-tpu-torch-0.1",
                                     "coordinator": True})
                    return
                if parts == ["ui"] or parts == ["ui", ""]:
                    # minimal live query console (the 62k-LoC React UI's
                    # essential surface: query list + states)
                    import html as _html

                    rows = []
                    qs = list(manager.queries.values())
                    for q in sorted(qs, key=lambda x: x.created)[-50:][::-1]:
                        sql_short = (q.sql[:100] + "…") if len(q.sql) > 100 \
                            else q.sql
                        wall = "" if q.wall_s is None else f"{q.wall_s:.2f}"
                        # user-controlled fields are escaped (stored-XSS
                        # guard: sql text / user name render as data)
                        rows.append(
                            f"<tr><td><a href=\"/ui/query/{_html.escape(q.id)}\""
                            f" style=\"color:#9cf\">{_html.escape(q.id)}</a></td>"
                            f"<td class={q.state}>{q.state}</td>"
                            f"<td>{_html.escape(str(q.session.user))}</td>"
                            f"<td>{wall}</td>"
                            f"<td>{_html.escape(sql_short)}</td></tr>")
                    body = _UI_PAGE.replace("%ROWS%", "\n".join(rows)) \
                        .encode()
                    self.send_response(200)
                    self.send_header("Content-Type",
                                     "text/html; charset=utf-8")
                    self.send_header("Content-Length", str(len(body)))
                    self.end_headers()
                    self.wfile.write(body)
                    return
                if parts[:2] == ["ui", "query"] and len(parts) == 3:
                    # per-query detail: live plan + operator stats (the
                    # reference UI's query.html stage/operator view)
                    import html as _html

                    q = manager.queries.get(parts[2])
                    if q is None:
                        self._send(404, {"error": "unknown query"})
                        return
                    sections = [
                        f"<h2>query {_html.escape(q.id)} "
                        f"<span class={q.state}>{q.state}</span></h2>",
                        f"<pre>{_html.escape(q.sql)}</pre>",
                    ]
                    if q.wall_s is not None:
                        sections.append(f"<p>wall: {q.wall_s:.3f} s, "
                                        f"rows: {len(q.rows)}</p>")
                    if q.error:
                        sections.append(
                            f"<p class=FAILED>{_html.escape(q.error)}</p>")
                    # one snapshot under the query's lock for the plan and
                    # the table: the query may still be inserting operators
                    snap = q.stats.snapshot() if q.stats is not None \
                        else None
                    if snap is not None and snap.operators:
                        try:  # annotated live plan (EXPLAIN ANALYZE view)
                            plan = manager.engine.plan(q.sql,
                                                       user=q.session.user)
                            sections.append(
                                "<h3>plan</h3><pre>"
                                + _html.escape(snap.render(plan))
                                + "</pre>")
                        except Exception:  # noqa: BLE001 — table instead
                            pass
                        ops = [
                            "<h3>operators</h3><table><tr><th>path</th>"
                            "<th>operator</th><th>wall ms</th>"
                            "<th>rows</th><th>calls</th></tr>"]
                        for path, op in sorted(snap.operators.items()):
                            ops.append(
                                f"<tr><td>{'/'.join(map(str, path)) or '.'}"
                                f"</td><td>{_html.escape(op.name)}"
                                f" {_html.escape(op.detail)}</td>"
                                f"<td>{op.wall_s * 1000:.2f}</td>"
                                f"<td>{op.output_rows}</td>"
                                f"<td>{op.invocations}</td></tr>")
                        sections.append("".join(ops) + "</table>")
                    body = _UI_DETAIL.replace(
                        "%BODY%", "".join(sections)).encode()
                    self.send_response(200)
                    self.send_header("Content-Type",
                                     "text/html; charset=utf-8")
                    self.send_header("Content-Length", str(len(body)))
                    self.end_headers()
                    self.wfile.write(body)
                    return
                self._send(404, {"error": "not found"})

            def do_DELETE(self):
                parts = self.path.strip("/").split("/")
                if parts[:2] == ["v1", "statement"] and len(parts) == 3:
                    ok = manager.cancel(parts[2])
                    self._send(200 if ok else 404, {"canceled": ok})
                    return
                self._send(404, {"error": "not found"})

        self.httpd = ThreadingHTTPServer((host, port), Handler)
        self.port = self.httpd.server_address[1]
        self._thread: Optional[threading.Thread] = None

    def start(self) -> "CoordinatorServer":
        if self.cluster is not None:
            self.cluster.registry.start()  # the heartbeat prober
        self._thread = threading.Thread(target=self.httpd.serve_forever,
                                        daemon=True)
        self._thread.start()
        return self

    def stop(self) -> None:
        self.httpd.shutdown()
        self.httpd.server_close()
        if self._thread is not None:
            self._thread.join(timeout=10)
        if self.cluster is not None:
            self.cluster.registry.stop()
        self.manager.pool.shutdown(wait=False)
