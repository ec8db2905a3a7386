"""Worker host runtime: the per-host task server of the multi-host plane.

The re-design of the reference's worker surface over HTTP:

* task control  — ``POST /v1/task/{taskId}`` with a JSON body carrying the
  serialized plan fragment plus this task's table shard (splits), mirroring
  ``TaskResource.createOrUpdateTask`` (``server/TaskResource.java:123-127``)
  and ``SqlTaskManager``/``SqlTaskExecution``.
* task status   — ``GET /v1/task/{taskId}`` (the long-poll status fetcher's
  target, ``server/remotetask/ContinuousTaskStatusFetcher``).
* results       — ``GET /v1/task/{taskId}/results/{token}``: binary pages
  with ``X-P1-Page-Token`` / ``X-P1-Buffer-Complete`` headers — the pull
  protocol of ``operator/HttpPageBufferClient.java:321-376`` reduced to its
  essentials (tokens ack pages; re-fetch is idempotent).
* heartbeat     — ``GET /v1/status`` (probed by the coordinator's failure
  detector, ``failuredetector/HeartbeatFailureDetector.java:78``).
* metrics       — ``GET /v1/metrics``: the process's counters, among them
  every kernel family's launches (``ops/kernels.launch_counts``).
* announcements — the worker announces itself to the coordinator's
  discovery endpoint on a loop (airlift discovery analog,
  ``metadata/DiscoveryNodeManager``).
* shutdown      — ``PUT /v1/info/state`` with ``"SHUTTING_DOWN"`` drains
  active tasks then exits (``server/GracefulShutdownHandler.java:48-84``).
* internal authentication — with the cluster's shared secret every request
  but the heartbeat must carry its bearer (``security.internal_ok``, 401
  otherwise), and the worker sends it with its announcements and its page
  pulls from other workers.

Inside one worker a fragment runs on the worker's torch device through the
port's ``Executor`` or ``CompiledQuery`` (and so through its hand-written
kernels); between workers only fragments go down and pages come up.

The compiled route is never left quietly.  A compiled run whose data
outgrew a recorded capacity or key range (``ExecError`` from its guards)
discovers again on the current inputs and runs that program, counted in
``worker.fragments_rediscovered``; any other failure fails the task through
its status.  A fragment runs eagerly only for a reason the task reports in
its ``route`` and ``worker.eager_fragments`` counts: per-operator statistics
were asked for, the policy (``P1_WORKER_COMPILE``) left it eager, or a
remote input has a nested column.

HTTP requests are served on ``ThreadingHTTPServer`` threads, fragments
compute on ``FairTaskExecutor`` threads, and a task's scan columns upload on
another thread while its remote inputs are fetched; the catalog's column
cache is safe for that (``exec/catalog.py``), and all device work goes to
the process's current stream.

A task created with ``"trace": true`` keeps a ``QueryTrace`` of its own
(``trace.py``) and ships its spans in its info: ``task`` around all of it,
``task_fetch`` (its remote inputs: pages, bytes) with ``pages_decode`` (their
merge onto the device: bytes, rows), the executor's ``run`` / ``fragment`` /
``op:*`` / ``wait`` spans of its compute, ``partition_output`` (rows,
buffers) and ``pages_encode`` (pages, raw bytes, compressed bytes).  The
coordinator grafts them into the statement's trace.  Untraced, nothing is
recorded.
"""

from __future__ import annotations

import argparse
import contextvars
import json
import os
import threading
import time
import traceback
import uuid
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Dict, Optional
from urllib import request as urlrequest

import numpy as np
import torch

from .. import trace as tracing
from ..batch import hash_strings_host as _hash_strings_host
# a column part as host numpy: a device tensor is read back here, since
# pages are serialized straight after
from ..exec.pages import _np as _host

PAGE_MAX_ROWS = 65536


class TaskState:
    RUNNING = "RUNNING"
    FINISHED = "FINISHED"
    FAILED = "FAILED"
    ABORTED = "ABORTED"


class WorkerTask:
    def __init__(self, task_id: str):
        self.id = task_id
        self.state = TaskState.RUNNING
        self.error: Optional[str] = None
        # output buffers partitioned by destination (the reference's
        # PartitionedOutputBuffer / ClientBuffer family): buffers[p] is the
        # page list served to downstream consumer p; unpartitioned tasks
        # have exactly one buffer
        self.buffers: list = [[]]
        self.bytes_in = 0   # pages pulled from upstream tasks
        self.bytes_out = 0  # pages served to consumers
        # per-key [min, max] of this task's output key columns, when the
        # coordinator asked for them (DynamicFilterService's worker side —
        # server/TaskResource.java:221 dynamic-filter fetch endpoint)
        self.domains: Optional[dict] = None
        # per-operator stats rollup shipped in task info (the reference's
        # OperatorStats -> TaskStats path, server/TaskResource.java)
        self.operator_stats: Optional[list] = None
        self.created = time.time()
        self.heartbeat = time.time()
        self.done = threading.Event()
        # wall breakdown: exchange wait (incl. upstream execution it
        # overlaps) vs total — overlap evidence in stage_stats
        self.fetch_ms = 0.0
        self.wall_ms = 0.0
        # hot key hashes detected at partition time (skew probe side)
        self.hot_keys: Optional[list] = None
        # how the fragment ran: "compiled", "rediscovered" or
        # "eager:<reason>" (WorkerRuntime._compute)
        self.route: Optional[str] = None
        # ms making the output pages (partition + serialize) and reading
        # the inputs' pages (decode + merge + placing them on the device)
        self.serialize_ms = 0.0
        self.decode_ms = 0.0
        # the task's own spans, where the coordinator asked for a trace
        self.spans: Optional[list] = None

    def info(self) -> dict:
        return {"taskId": self.id, "state": self.state, "error": self.error,
                "pages": sum(len(b) for b in self.buffers),
                "buffers": len(self.buffers),
                "bytesIn": self.bytes_in, "bytesOut": self.bytes_out,
                "domains": self.domains,
                "operatorStats": self.operator_stats,
                "fetchMs": self.fetch_ms, "wallMs": self.wall_ms,
                "hotKeys": self.hot_keys, "route": self.route,
                "serializeMs": self.serialize_ms,
                "decodeMs": self.decode_ms, "spans": self.spans}


def _paginate(out, lo0: int, n: int) -> list:
    """Serialize rows [lo0, n) into bounded pages (idempotent token
    fetches)."""
    from dataclasses import replace as _replace

    from ..batch import RecordBatch
    from ..exec.pages import page_raw_bytes, serialize_batch

    pages = []
    detail = None if tracing.TRACE.get() is None else {}
    with tracing.span("pages_encode", detail):
        for lo in range(lo0, max(n, lo0 + 1), PAGE_MAX_ROWS):
            hi = min(lo + PAGE_MAX_ROWS, n)
            cols = {}
            for name, c in out.columns.items():
                cols[name] = _replace(
                    c, data=c.data[lo:hi],
                    validity=(c.validity[lo:hi] if c.validity is not None
                              else None),
                    lengths=(c.lengths[lo:hi] if c.lengths is not None
                             else None),
                    map_values=(c.map_values[lo:hi]
                                if c.map_values is not None else None))
            pages.append(serialize_batch(RecordBatch(cols,
                                                     max(hi - lo, 0))))
            if hi >= n:
                break
    if detail is not None:
        detail.update(pages=len(pages),
                      raw_bytes=sum(map(page_raw_bytes, pages)),
                      bytes=sum(map(len, pages)))
    return pages


# hash value for NULL lanes: distinct from any bit pattern a legitimate
# zero-valued key produces (NULLs must not co-hash with 0-valued keys)
_NULL_HASH = 0x9E3779B97F4A7C15


def _key_hash_host(batch, n: int, keys) -> np.ndarray:
    """Deterministic cross-host row hash of the key columns.

    Dictionary-coded strings hash by VALUE (each worker's dictionary is
    local, so codes are not comparable across hosts); numerics by their
    int64 bits.  Must be identical on every host — it routes co-partitioned
    rows to the same downstream task (PartitionFunction analog,
    ``operator/PartitionedOutputOperator.java:406``) — and it is the JAX
    package's hash bit for bit."""
    mix = np.uint64(0x9E3779B97F4A7C15)
    h = np.zeros(n, np.uint64)
    with np.errstate(over="ignore"):
        for name in keys:
            c = batch[name]
            data = _host(c.data[:n])
            if c.dictionary is not None:
                dvals = _hash_strings_host(c.dictionary)
                if len(dvals):
                    v = dvals[np.clip(data, 0, len(dvals) - 1)]
                else:
                    v = np.zeros(n, np.uint64)
            elif data.dtype.kind == "f":
                v = data.astype(np.float64).view(np.uint64)
            else:
                v = data.astype(np.int64).view(np.uint64)
            if c.validity is not None:
                v = np.where(_host(c.validity[:n]), v,
                             np.uint64(_NULL_HASH))
            h = h * np.uint64(0x100000001B3) + ((v * mix) >> np.uint64(33))
    return h


def _partition_output(out, n: int, keys, count: int,
                      collect_hot: Optional[float] = None,
                      hot_hashes: Optional[list] = None,
                      task: Optional["WorkerTask"] = None) -> list:
    """Hash-partition the task output into ``count`` destination buffers
    (PartitionedOutputBuffer).  Runs on the host: the pages are serialized
    on the host anyway, and the hash must be cross-host deterministic.  The
    output is read back once; each buffer's columns are host tensors.

    Skew handling (the reference's PartitionedOutputOperator has no skew
    path): with ``collect_hot`` (probe side), key hashes whose row count
    exceeds threshold x fair-share scatter ROUND-ROBIN across destinations
    and the hashes are reported in task info; with ``hot_hashes`` (build
    side, the coordinator-merged union of all probe reports), those rows
    replicate into EVERY buffer — every scattered probe row still meets all
    of its build rows, while the hot load spreads over all tasks."""
    from ..batch import Column, RecordBatch

    if n == 0:
        return [_paginate(out, 0, 0) for _ in range(count)]
    h = _key_hash_host(out, n, keys)
    part = (h % np.uint64(count)).astype(np.int64)
    bcast = None
    if collect_hot and n:
        vals, cnts = np.unique(h, return_counts=True)
        fair = max(n / count, 1.0)
        hotm = cnts > float(collect_hot) * fair
        if hotm.any():
            hot = vals[hotm]
            order = np.argsort(cnts[hotm])[::-1][:64]  # top-64 by count
            hot = hot[order]
            rows = np.isin(h, hot)
            part[rows] = np.arange(int(rows.sum())) % count
            if task is not None:
                task.hot_keys = [int(x) for x in hot]
    if hot_hashes:
        bcast = np.isin(h, np.asarray(
            [np.uint64(x) for x in hot_hashes], dtype=np.uint64))
    host_cols = {name: (_host(c.data[:n]),
                        None if c.validity is None
                        else _host(c.validity[:n]),
                        None if c.lengths is None
                        else _host(c.lengths[:n]),
                        None if c.map_values is None
                        else _host(c.map_values[:n]))
                 for name, c in out.columns.items()}

    def part_of(a, sel):
        return None if a is None else torch.from_numpy(
            np.ascontiguousarray(a[sel]))

    buffers = []
    for p in range(count):
        sel = part == p
        if bcast is not None:
            sel = sel | bcast  # hot build rows ride every buffer
        cols = {}
        for name, (data, validity, lengths, mv) in host_cols.items():
            c = out[name]
            cols[name] = Column(
                part_of(data, sel), c.type, validity=part_of(validity, sel),
                dictionary=c.dictionary, lengths=part_of(lengths, sel),
                map_values=part_of(mv, sel))
        rows = int(sel.sum())
        buffers.append(_paginate(RecordBatch(cols, rows), 0, rows))
    return buffers


def _fetch_location(loc, auth: Dict[str, str]) -> tuple:
    """Token-acked long-poll pull of ONE upstream buffer (the per-client
    loop of ``operator/HttpPageBufferClient.java:321``): pages deserialize
    (to host tensors) as they arrive, so the wire wait and the decode
    overlap.  ``auth``: the headers every pull carries (the cluster's
    internal bearer)."""
    from ..exec.dist_engine import exchange_deadline_s
    from ..exec.pages import deserialize_batch

    batches = []
    nbytes = 0
    decode_s = 0.0
    token = 0
    deadline = time.time() + exchange_deadline_s()
    while True:
        url = (f"{loc['uri']}/v1/task/{loc['task']}/results/"
               f"{loc['buffer']}/{token}")
        req = urlrequest.Request(url, method="GET", headers=auth)
        with urlrequest.urlopen(req, timeout=60) as resp:
            data = resp.read()
            headers = dict(resp.headers)
        if headers.get("X-P1-Buffer-Complete") == "true":
            return batches, nbytes, decode_s
        if headers.get("X-P1-Page-Present") == "true":
            nbytes += len(data)
            t0 = time.perf_counter()
            batches.append(deserialize_batch(data))
            decode_s += time.perf_counter() - t0
            token += 1
            deadline = time.time() + exchange_deadline_s()
        elif time.time() > deadline:
            raise RuntimeError(
                f"upstream task {loc['task']} produced no page for "
                f"{exchange_deadline_s():.0f}s (deadline)")


_FETCH_PARALLELISM = int(os.environ.get("P1_EXCHANGE_CONCURRENCY", "16"))


def _fetch_sources_concurrent(sources: dict, device,
                              headers: Dict[str, str]) -> tuple:
    """Pull EVERY upstream buffer of every stub concurrently (the
    reference's ExchangeClient keeps one HttpPageBufferClient per upstream
    task, all in flight at once — ``operator/ExchangeClient.java:149``),
    then merge each stub's pages on the host and place it on ``device``.
    Upstream tasks finish at different times; concurrent pulls mean this
    task's wait is max(upstream walls), not their sum.  Returns the stubs,
    the pages and bytes pulled and the seconds spent decoding, merging and
    placing them (the merge is the span ``pages_decode``).  ``headers`` go
    with every pull (the cluster's internal bearer)."""
    from concurrent.futures import ThreadPoolExecutor

    from ..exec.pages import concat_batches

    jobs = []  # (path, order index, location)
    for path_str, locations in sources.items():
        path = tuple(int(x) for x in path_str.split(",") if x != "")
        for i, loc in enumerate(locations):
            jobs.append((path, i, loc))
    # a bounded pool, not thread-per-buffer: a wide fan-in (hundreds of
    # upstream tasks) must not create hundreds of OS threads
    results: dict = {}
    with ThreadPoolExecutor(
            max_workers=min(_FETCH_PARALLELISM, max(len(jobs), 1)),
            thread_name_prefix="exchange-fetch") as pool:
        futures = {pool.submit(_fetch_location, loc, headers): (path, i)
                   for path, i, loc in jobs}
        for fut, key in futures.items():
            results[key] = fut.result()
    stubs = {}
    total_bytes = pages = 0
    decode_s = 0.0
    t0 = time.perf_counter()
    detail = None if tracing.TRACE.get() is None else {}
    with tracing.span("pages_decode", detail):
        for path_str, locations in sources.items():
            path = tuple(int(x) for x in path_str.split(",") if x != "")
            batches = []
            for i in range(len(locations)):
                b, nb, ds = results[(path, i)]
                batches.extend(b)
                total_bytes += nb
                decode_s += ds
            pages += len(batches)
            merged = concat_batches(batches, device=device)
            if merged is None:
                raise RuntimeError("remote source produced no pages")
            stubs[path] = merged
    if detail is not None:
        detail.update(bytes=total_bytes,
                      rows=sum(int(b.num_rows) for b in stubs.values()))
    return stubs, pages, total_bytes, decode_s + time.perf_counter() - t0


def _scans_outside_stubs(plan, stub_paths) -> list:
    """The Scan nodes of a fragment that it runs itself: none under a
    remote source's stub path (those subtrees are the upstream stages'
    plans, kept for their schema, and are never executed here)."""
    from ..sql.logical import Scan

    out, stack = [], [(plan, ())]
    while stack:
        node, path = stack.pop()
        if path in stub_paths:
            continue
        if isinstance(node, Scan):
            out.append(node)
        stack.extend((c, path + (i,)) for i, c in enumerate(node.children))
    return out


def _prefetch_scans(plan, catalog, stub_paths) -> None:
    """Upload this fragment's scan columns while its remote pages are in
    flight (overlaps the upload with the exchange wait — the scheduling
    overlap PhasedExecutionSchedule buys the reference).  The tables under
    the stubs are not touched (the JAX package uploads them too: ROADMAP
    C24)."""
    for node in _scans_outside_stubs(plan, stub_paths):
        t = catalog.table(node.table)
        for col in node.symbols:
            t.column(col)


def _make_catalog(spec, device):
    """The catalog on ``device`` from a node's catalog properties (a dict,
    read by ``server/config.py::build_catalog`` as the coordinator reads
    its own) or from a spec 'tpch:tiny' / 'tpch:sf1'."""
    from .config import build_catalog

    if isinstance(spec, dict):
        return build_catalog(spec, spec.get("connector.name", "catalog"),
                             device=device)
    kind, _, arg = spec.partition(":")
    if kind == "tpch":
        return build_catalog({"connector.name": "tpch",
                              "tpch.schema": arg or "tiny"}, spec,
                             device=device)
    raise ValueError(f"unknown catalog spec {spec}")


def _metrics_snapshot() -> list:
    """The process's metrics (``exec/metrics.REGISTRY``) and every kernel
    family's launches so far, as ``kernel.<family>.launches`` counters."""
    from ..exec.metrics import REGISTRY
    from ..ops.kernels import launch_counts

    out = REGISTRY.snapshot()
    for fam, n in sorted(launch_counts().items()):
        out.append({"name": f"kernel.{fam}.launches", "kind": "counter",
                    "total": float(n), "one_minute": 0.0,
                    "min": 0.0, "max": 0.0, "avg": 0.0})
    return out


class WorkerRuntime:
    """Owns tasks and executes fragments (SqlTaskManager analog).
    ``catalog``: the node's catalog properties, or a spec 'tpch:<schema>'
    (``_make_catalog``)."""

    def __init__(self, catalog, device="cuda",
                 internal_secret: Optional[str] = None):
        from .security import internal_headers

        self.node_id = uuid.uuid4().hex[:12]
        # the cluster's shared secret (None: no internal authentication)
        self.internal_secret = internal_secret
        self.internal_headers = internal_headers(internal_secret)
        self.catalog_spec = catalog
        self.device = torch.device(device)
        self._base_catalog = None
        self._catalog_lock = threading.Lock()
        # one catalog view a shard, kept: its columns upload once and stay
        # on the device for every later task of that shard
        self._shards: Dict[tuple, object] = {}
        self.tasks: Dict[str, WorkerTask] = {}
        self.started = time.time()
        self.draining = False
        # fragment program cache (LocalExecutionPlanner analog): fragments
        # compile into CompiledQuery programs keyed by (fragment
        # fingerprint, shard, stub-shape signature).  Policy 'auto'
        # compiles on the SECOND use of a signature, or on the first when
        # its input is large; 'always' and 'off' as named.
        self.compile_policy = os.environ.get("P1_WORKER_COMPILE", "auto")
        self._frag_cache: Dict[str, object] = {}
        self._frag_seen: Dict[str, int] = {}
        self._frag_lock = threading.Lock()
        # fair compute scheduling (TaskExecutor + MultilevelSplitQueue
        # analog): fragment compute phases run on a bounded pool ordered
        # by each query's accumulated level; exchange fetches stay on
        # the task thread so a blocked fetch never occupies a runner
        from .task_executor import FairTaskExecutor

        self.task_executor = FairTaskExecutor()

    def base_catalog(self):
        with self._catalog_lock:
            if self._base_catalog is None:
                self._base_catalog = _make_catalog(self.catalog_spec,
                                                   self.device)
            return self._base_catalog

    def shard_catalog(self, index: int, count: int):
        """The view of shard ``index`` of ``count`` of every table (made
        once per shard; it never uploads a whole table)."""
        from ..exec.catalog import ShardedCatalog

        base = self.base_catalog()
        with self._catalog_lock:
            view = self._shards.get((index, count))
            if view is None:
                view = self._shards[(index, count)] = ShardedCatalog(
                    base, index, count)
            return view

    def create_task(self, task_id: str, body: dict) -> WorkerTask:
        if task_id in self.tasks:
            return self.tasks[task_id]
        if self.draining:
            raise RuntimeError("worker is shutting down")
        task = WorkerTask(task_id)
        self.tasks[task_id] = task
        threading.Thread(target=self._run, args=(task, body),
                         daemon=True).start()
        return task

    def _run(self, task: WorkerTask, body: dict) -> None:
        from ..exec.metrics import REGISTRY

        trace = tracing.QueryTrace(task.id) if body.get("trace") else None
        try:
            with tracing.enter(trace, "task", {"node": self.node_id,
                                               "task": task.id}):
                n = self._execute(task, body)
            if trace is not None:
                task.spans = trace.spans
            task.state = TaskState.FINISHED
            REGISTRY.counter("worker.tasks_finished").update()
            REGISTRY.counter("worker.output_rows").update(n)
            REGISTRY.counter("worker.exchange_bytes_in").update(
                task.bytes_in)
        except Exception as e:  # noqa: BLE001 — reported via task status
            REGISTRY.counter("worker.tasks_failed").update()
            task.error = f"{type(e).__name__}: {e}"
            traceback.print_exc()
            task.state = TaskState.FAILED
        finally:
            task.done.set()

    def _execute(self, task: WorkerTask, body: dict) -> int:
        """The task's work up to its output buffers; returns its rows."""
        from ..sql.serde import plan_from_json

        plan = plan_from_json(body["fragment"])
        shard = body.get("shard")
        catalog = self.base_catalog() if shard is None \
            else self.shard_catalog(shard["index"], shard["count"])
        # remote sources: this task consumes other tasks' partitioned
        # buffers (the ExchangeOperator/ExchangeClient side,
        # operator/ExchangeClient.java:56) — every upstream buffer
        # pulls CONCURRENTLY, and the fragment's scan columns upload
        # under the exchange wait
        t_start = time.time()
        sources = body.get("sources") or {}
        stub_paths = {tuple(int(x) for x in p.split(",") if x != "")
                      for p in sources}
        stubs = {}
        fetched = None if tracing.TRACE.get() is None else {}
        if sources:
            pf_error: list = []

            def prefetch():
                try:
                    _prefetch_scans(plan, catalog, stub_paths)
                except Exception as e:  # noqa: BLE001 — fails the task
                    pf_error.append(e)

            pf = threading.Thread(target=prefetch, daemon=True)
            pf.start()
            with tracing.span("task_fetch", fetched):
                stubs, pages, nbytes, decode_s = \
                    _fetch_sources_concurrent(sources, self.device,
                                              self.internal_headers)
            if fetched is not None:
                fetched.update(pages=pages, bytes=nbytes)
            task.bytes_in += nbytes
            task.decode_ms = round(decode_s * 1000, 3)
            pf.join()
            if pf_error:
                raise pf_error[0]
        task.fetch_ms = round((time.time() - t_start) * 1000, 3)

        t0 = time.time()
        # fragment compute runs under the fair MLFQ scheduler keyed
        # by the query's accumulated time (coordinator-assigned query
        # id; standalone tasks fall back to their task id), on a
        # runner thread that records into this task's trace while this
        # thread waits
        ctx = contextvars.copy_context()
        out, qstats = self.task_executor.run(
            body.get("query") or task.id,
            lambda: ctx.run(self._compute, task, body, plan, catalog,
                            shard, stubs))
        n = tracing.host_read(out.num_rows)
        if qstats is None:
            task.operator_stats = [
                {"path": [], "name": "CompiledFragment",
                 "wallMs": round((time.time() - t0) * 1000, 3),
                 "rows": n, "invocations": 1}]
        else:
            qstats.wall_s = time.time() - t0
            task.operator_stats = [
                {"path": list(path), "name": op.name,
                 "wallMs": round(op.wall_s * 1000, 3),
                 "rows": int(op.output_rows),
                 "invocations": op.invocations}
                for path, op in qstats.items()
            ]

        collect = body.get("collect_domains")
        if collect:
            doms = {}
            for key in collect:
                c = out[key]
                if c.dictionary is not None:
                    doms[key] = None  # strings: no range domain
                    continue
                data = _host(c.data[:n])
                if c.validity is not None:
                    data = data[_host(c.validity[:n])]
                doms[key] = ([data.min().item(), data.max().item()]
                             if data.size else [])
            task.domains = doms

        t_pages = time.perf_counter()
        part = body.get("output_partitioning")
        if part is not None:
            with tracing.span("partition_output",
                              {"rows": n, "buffers": int(part["count"])}):
                task.buffers = _partition_output(
                    out, n, part["keys"], int(part["count"]),
                    collect_hot=body.get("collect_hot"),
                    hot_hashes=body.get("hot_hashes"), task=task)
        else:
            task.buffers = [_paginate(out, 0, n)]
        task.serialize_ms = round(
            (time.perf_counter() - t_pages) * 1000, 3)
        task.wall_ms = round((time.time() - t_start) * 1000, 3)
        return n

    def _compute(self, task, body, plan, catalog, shard, stubs):
        """Run the fragment: ``(output batch, QueryStats or None)``.  The
        route taken is set on the task and counted."""
        from ..exec.executor import Executor
        from ..exec.metrics import REGISTRY
        from ..exec.stats import QueryStats

        reason = None
        if body.get("collect_stats"):
            # EXPLAIN ANALYZE / info= rollups need per-operator attribution,
            # which only the eager executor produces
            reason = "stats"
        elif self.compile_policy == "off":
            reason = "policy"
        elif any(c.is_nested for b in stubs.values()
                 for c in b.columns.values()):
            # a nested remote input: the compiled route does not take
            # nested external inputs
            reason = "nested-input"
        if reason is None:
            out = self._compiled(task, body, plan, catalog, shard, stubs)
            if out is not None:
                return out, None
            reason = "first-sighting"
        task.route = f"eager:{reason}"
        REGISTRY.counter("worker.eager_fragments").update()
        qstats = QueryStats()
        out = Executor(catalog, stubs=stubs, stats=qstats,
                       device=self.device).execute(plan)
        return out, qstats

    def _frag_signature(self, body: dict, shard, stubs) -> str:
        """Cache key: fragment fingerprint x shard x stub shape/dictionary
        signature.  Dictionaries matter — the compiled program folds string
        comparisons against them."""
        import hashlib

        h = hashlib.sha256()
        h.update(json.dumps(body["fragment"], sort_keys=True).encode())
        h.update(json.dumps(shard, sort_keys=True).encode())
        for path in sorted(stubs):
            b = stubs[path]
            h.update(str(path).encode())
            h.update(str(b.capacity()).encode())
            for name, c in b.columns.items():
                h.update(name.encode())
                h.update(str(c.data.dtype).encode())
                h.update(str(tuple(c.data.shape)).encode())
                h.update(b"v" if c.validity is not None else b"-")
                h.update(b"n" if c.lengths is not None else b"-")
                if c.dictionary is not None:
                    h.update(np.asarray(c.dictionary, dtype="U").tobytes())
        return h.hexdigest()

    def _input_rows(self, plan, catalog, stubs) -> int:
        """Rows a fragment reads: its remote inputs' and its own scans'."""
        rows = sum(int(b.num_rows) for b in stubs.values())
        for node in _scans_outside_stubs(plan, set(stubs)):
            rows += int(catalog.table(node.table).num_rows)
        return rows

    def _compiled(self, task, body, plan, catalog, shard, stubs):
        """The fragment through its cached compiled program, or None when
        the policy runs this sighting eagerly.

        Policy 'auto': compile on the SECOND sighting of a (fragment,
        shard, stub-shape) signature, or on the first when the fragment
        reads at least ``P1_WORKER_COMPILE_ROWS`` rows (the reference
        compiles every task's fragment up front,
        ``sql/planner/LocalExecutionPlanner.java:390``).  Building the
        program and running it raise like any task error; only a tripped
        capacity or range guard (``ExecError``) is caught, and it discovers
        again on this task's inputs -- once; a second failure fails the
        task."""
        from ..exec.executor import CompiledQuery, ExecError
        from ..exec.metrics import REGISTRY

        sig = self._frag_signature(body, shard, stubs)
        with self._frag_lock:
            seen = self._frag_seen.get(sig, 0)
            self._frag_seen[sig] = seen + 1
            cq = self._frag_cache.get(sig)
        if cq is None:
            hot = self.compile_policy == "auto" and seen == 0 and \
                self._input_rows(plan, catalog, stubs) >= int(
                    os.environ.get("P1_WORKER_COMPILE_ROWS", "262144"))
            if not (self.compile_policy == "always" or seen >= 1 or hot):
                return None
            cq = CompiledQuery(catalog, plan, stubs=stubs,
                               device=self.device)
            with self._frag_lock:
                self._frag_cache[sig] = cq
            REGISTRY.counter("worker.fragments_compiled").update()
        try:
            out = cq(stubs=stubs)
            task.route = "compiled"
        except ExecError as e:
            # the data outgrew what discovery recorded: discover again on
            # these inputs (never truncate, never fall back to eager)
            print(f"worker {self.node_id}: task {task.id} rediscovers: {e}",
                  flush=True)
            REGISTRY.counter("worker.fragments_rediscovered").update()
            cq = CompiledQuery(catalog, plan, stubs=stubs,
                               device=self.device)
            with self._frag_lock:
                self._frag_cache[sig] = cq
            out = cq(stubs=stubs)
            task.route = "rediscovered"
        REGISTRY.counter("worker.compiled_task_runs").update()
        return out

    def abort(self, task_id: str) -> bool:
        task = self.tasks.get(task_id)
        if task is None:
            return False
        if task.state == TaskState.RUNNING:
            task.state = TaskState.ABORTED
        return True

    def status(self) -> dict:
        return {
            "nodeId": self.node_id,
            "state": "SHUTTING_DOWN" if self.draining else "ACTIVE",
            "device": str(self.device),
            "uptime_s": time.time() - self.started,
            "tasks": {s: sum(1 for t in list(self.tasks.values())
                             if t.state == s)
                      for s in (TaskState.RUNNING, TaskState.FINISHED,
                                TaskState.FAILED)},
        }


class WorkerServer:
    """``catalog_spec``: the node's catalog properties, or 'tpch:<schema>'
    (``WorkerRuntime``).  ``internal_secret``: the cluster's shared
    secret, asked of every request but the heartbeat."""

    def __init__(self, catalog_spec, host: str = "127.0.0.1",
                 port: int = 0, coordinator: Optional[str] = None,
                 announce_interval_s: float = 1.0, device="cuda",
                 internal_secret: Optional[str] = None):
        from .security import internal_ok

        self.runtime = WorkerRuntime(catalog_spec, device=device,
                                     internal_secret=internal_secret)
        runtime = self.runtime
        server = self

        class Handler(BaseHTTPRequestHandler):
            protocol_version = "HTTP/1.1"

            def log_message(self, fmt, *args):
                pass

            def _send_json(self, code: int, payload: dict):
                body = json.dumps(payload).encode()
                self.send_response(code)
                self.send_header("Content-Type", "application/json")
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                self.wfile.write(body)

            def _refused(self) -> bool:
                """Answers 401, having read the body, where the request
                lacks the cluster's bearer; the heartbeat needs none."""
                if self.path.strip("/") == "v1/status" or internal_ok(
                        self.headers, runtime.internal_secret):
                    return False
                self.rfile.read(int(self.headers.get("Content-Length",
                                                     "0")))
                self._send_json(401, {
                    "error": "internal authentication failed"})
                return True

            def do_POST(self):
                if self._refused():
                    return
                parts = self.path.strip("/").split("/")
                if parts[:2] == ["v1", "task"] and len(parts) == 3:
                    length = int(self.headers.get("Content-Length", "0"))
                    body = json.loads(self.rfile.read(length).decode())
                    try:
                        task = runtime.create_task(parts[2], body)
                    except RuntimeError as e:
                        self._send_json(503, {"error": str(e)})
                        return
                    self._send_json(200, task.info())
                    return
                self._send_json(404, {"error": "not found"})

            def do_GET(self):
                if self._refused():
                    return
                parts = self.path.strip("/").split("/")
                if parts == ["v1", "status"]:
                    self._send_json(200, runtime.status())
                    return
                if parts == ["v1", "metrics"]:
                    # worker metrics snapshot (the per-node JMX surface:
                    # trino-jmx exposes MBeans per worker the same way)
                    self._send_json(200, {"metrics": _metrics_snapshot()})
                    return
                if parts[:2] == ["v1", "task"] and len(parts) == 3:
                    task = runtime.tasks.get(parts[2])
                    if task is None:
                        self._send_json(404, {"error": "unknown task"})
                        return
                    task.heartbeat = time.time()
                    self._send_json(200, task.info())
                    return
                if (parts[:2] == ["v1", "task"] and len(parts) in (5, 6)
                        and parts[3] == "results"):
                    # /v1/task/{id}/results/{token}            (buffer 0)
                    # /v1/task/{id}/results/{buffer}/{token}   (partitioned)
                    task = runtime.tasks.get(parts[2])
                    if task is None:
                        self._send_json(404, {"error": "unknown task"})
                        return
                    buffer_id = int(parts[4]) if len(parts) == 6 else 0
                    token = int(parts[5] if len(parts) == 6 else parts[4])
                    # long-poll up to 10s; a still-running task answers with
                    # an EMPTY non-complete response and the client re-polls
                    # the same token (HttpPageBufferClient's token protocol:
                    # completeness is a property of the buffer, never of a
                    # poll timeout)
                    deadline = time.time() + 10.0
                    while (task.state == TaskState.RUNNING
                           and time.time() < deadline):
                        task.done.wait(0.05)
                    if task.state == TaskState.FAILED:
                        self._send_json(500, {"error": task.error})
                        return
                    running = task.state == TaskState.RUNNING
                    buf = ([] if running or buffer_id >= len(task.buffers)
                           else task.buffers[buffer_id])
                    complete = (not running) and token >= len(buf)
                    has_page = (not running) and token < len(buf)
                    body = buf[token] if has_page else b""
                    if has_page:
                        task.bytes_out += len(body)
                    self.send_response(200)
                    self.send_header("Content-Type",
                                     "application/x-p1-pages")
                    self.send_header("X-P1-Page-Token", str(token))
                    self.send_header("X-P1-Page-Present",
                                     "true" if has_page else "false")
                    self.send_header("X-P1-Buffer-Complete",
                                     "true" if complete else "false")
                    self.send_header("Content-Length", str(len(body)))
                    self.end_headers()
                    self.wfile.write(body)
                    return
                self._send_json(404, {"error": "not found"})

            def do_DELETE(self):
                if self._refused():
                    return
                parts = self.path.strip("/").split("/")
                if parts[:2] == ["v1", "task"] and len(parts) == 3:
                    ok = runtime.abort(parts[2])
                    self._send_json(200 if ok else 404, {"aborted": ok})
                    return
                self._send_json(404, {"error": "not found"})

            def do_PUT(self):
                if self._refused():
                    return
                parts = self.path.strip("/").split("/")
                if parts == ["v1", "info", "state"]:
                    length = int(self.headers.get("Content-Length", "0"))
                    state = json.loads(self.rfile.read(length).decode())
                    if state == "SHUTTING_DOWN":
                        runtime.draining = True
                        threading.Thread(target=server._drain_and_exit,
                                         daemon=True).start()
                        self._send_json(200, {"state": "SHUTTING_DOWN"})
                        return
                    self._send_json(400, {"error": f"bad state {state}"})
                    return
                self._send_json(404, {"error": "not found"})

        self.httpd = ThreadingHTTPServer((host, port), Handler)
        self.host = host
        self.port = self.httpd.server_address[1]
        self.coordinator = coordinator
        self.announce_interval_s = announce_interval_s
        self._threads: list = []
        self._stop = threading.Event()

    def uri(self) -> str:
        return f"http://{self.host}:{self.port}"

    def start(self) -> "WorkerServer":
        t = threading.Thread(target=self.httpd.serve_forever, daemon=True)
        t.start()
        self._threads.append(t)
        if self.coordinator:
            a = threading.Thread(target=self._announce_loop, daemon=True)
            a.start()
            self._threads.append(a)
        return self

    def _announce_loop(self) -> None:
        topology = {k: os.environ[f"P1_NODE_{k.upper()}"]
                    for k in ("rack", "host", "pod")
                    if os.environ.get(f"P1_NODE_{k.upper()}")}
        spec = self.runtime.catalog_spec
        payload = json.dumps({
            "nodeId": self.runtime.node_id, "uri": self.uri(),
            "catalog": spec if isinstance(spec, str)
            else spec.get("connector.name"),
            "topology": topology,
        }).encode()
        while not self._stop.is_set():
            try:
                req = urlrequest.Request(
                    f"{self.coordinator}/v1/announcement/"
                    f"{self.runtime.node_id}",
                    data=payload, method="PUT",
                    headers={"Content-Type": "application/json",
                             **self.runtime.internal_headers})
                urlrequest.urlopen(req, timeout=5).read()
            except Exception:  # noqa: BLE001 — re-announce next tick
                pass
            self._stop.wait(self.announce_interval_s)

    def _drain_and_exit(self) -> None:
        while any(t.state == TaskState.RUNNING
                  for t in list(self.runtime.tasks.values())):
            time.sleep(0.1)
        self.stop()
        os._exit(0)

    def stop(self) -> None:
        self._stop.set()
        self.httpd.shutdown()
        self.httpd.server_close()
        self.runtime.task_executor.stop()
        for t in self._threads:
            t.join(timeout=10)


def _exit_with(pid: int, interval_s: float = 1.0) -> None:
    """Exit this process once process ``pid`` no longer exists."""
    while True:
        try:
            os.kill(pid, 0)
        except ProcessLookupError:
            os._exit(0)
        except PermissionError:
            pass  # alive, owned by another user
        time.sleep(interval_s)


def main(argv=None):
    ap = argparse.ArgumentParser(description="presto1_tpu_torch worker host")
    ap.add_argument("--catalog", default="tpch:tiny")
    ap.add_argument("--host", default="127.0.0.1")
    ap.add_argument("--port", type=int, default=0)
    ap.add_argument("--coordinator", default=None,
                    help="coordinator URI for discovery announcements")
    ap.add_argument("--device", default="cuda",
                    help="torch device the fragments run on (default: cuda; "
                         "cpu runs without a card)")
    ap.add_argument("--parent-pid", type=int, default=None,
                    help="exit when this process is gone (a launcher that "
                         "dies leaves no worker behind)")
    args = ap.parse_args(argv)
    if args.parent_pid is not None:
        threading.Thread(target=_exit_with, args=(args.parent_pid,),
                         daemon=True).start()
    srv = WorkerServer(args.catalog, args.host, args.port,
                       coordinator=args.coordinator,
                       device=args.device).start()
    print(json.dumps({"uri": srv.uri(), "nodeId": srv.runtime.node_id,
                      "device": args.device}), flush=True)
    try:
        while True:
            time.sleep(3600)
    except KeyboardInterrupt:
        srv.stop()


if __name__ == "__main__":
    main()
