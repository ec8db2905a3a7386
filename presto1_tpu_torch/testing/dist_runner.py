"""In-test multi-host launcher (DistributedQueryRunner analog).

The reference boots ``nodeCount`` real ``TestingTrinoServer`` instances in
one JVM with real HTTP between them
(``testing/trino-testing/.../DistributedQueryRunner.java:99-149``).  Here
each worker is a separate OS **process** (``python -m
presto1_tpu_torch.server.worker --device <device>``: its own torch runtime,
its own memory, its own view of the card) speaking the HTTP task/results
protocol over localhost, with discovery announcements into the
coordinator's NodeRegistry.  Every wait is bounded, and every worker is
killed by ``close()`` (and exits by itself when the launching process is
gone).
"""

from __future__ import annotations

import os
import subprocess
import sys
import threading
import time
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import List, Optional

import torch

from ..exec.dist_engine import MultiHostEngine
from ..server.discovery import NodeRegistry, serve_discovery

# a worker process announces itself once torch is imported and its server
# listens: seconds, even on a loaded host or a card's first context
START_TIMEOUT_S = 120.0


class DiscoveryServer:
    """The discovery endpoint alone (``server/discovery.py::
    serve_discovery``, as a coordinator with
    ``node-scheduler.include-coordinator=false`` serves it), for a
    coordinator that runs in the test's process."""

    def __init__(self, registry: NodeRegistry, host: str = "127.0.0.1",
                 port: int = 0):
        reg = registry

        class Handler(BaseHTTPRequestHandler):
            protocol_version = "HTTP/1.1"

            def log_message(self, fmt, *args):
                pass

            def _serve(self, method: str):
                if not serve_discovery(reg, self, method):
                    self.send_response(404)
                    self.send_header("Content-Length", "0")
                    self.end_headers()

            def do_PUT(self):
                self._serve("PUT")

            def do_GET(self):
                self._serve("GET")

        self.httpd = ThreadingHTTPServer((host, port), Handler)
        self.port = self.httpd.server_address[1]
        self._thread: Optional[threading.Thread] = None

    def start(self) -> "DiscoveryServer":
        self._thread = threading.Thread(target=self.httpd.serve_forever,
                                        daemon=True)
        self._thread.start()
        return self

    def stop(self) -> None:
        self.httpd.shutdown()
        self.httpd.server_close()
        if self._thread is not None:
            self._thread.join(timeout=10)


class MultiHostRunner:
    """Boots N worker processes on ``device`` + an in-process coordinator
    (a ``MultiHostEngine`` whose final stages run on ``device`` too); tears
    everything down on close().

    The workers inherit this process's environment but ``JAX_*`` and
    ``XLA_*``: ``P1_TPCH_CACHE`` passes through, so workers read the TPC-H
    columns their launcher wrote, and ``P1_WORKER_COMPILE`` likewise.  On
    the CPU each worker computes with one intra-op thread (unless
    ``OMP_NUM_THREADS`` says otherwise): the workers share the host's cores
    with each other and the coordinator.  With ``log_dir`` each
    worker's output goes to ``worker-<i>.log`` there, else nowhere."""

    def __init__(self, n_workers: int = 2, catalog_spec: str = "tpch:tiny",
                 shards_per_node: int = 1,
                 broadcast_threshold: int = 100_000, device="cuda",
                 log_dir: Optional[str] = None):
        self.registry = NodeRegistry(probe_interval_s=0.25).start()
        self.discovery = DiscoveryServer(self.registry).start()
        self.workers: List[subprocess.Popen] = []
        self._logs: list = []
        self.catalog_spec = catalog_spec
        self.device = str(device)
        env = {k: v for k, v in os.environ.items()
               if not k.startswith(("JAX_", "XLA_"))}
        if torch.device(device).type == "cpu":
            env.setdefault("OMP_NUM_THREADS", "1")
        repo_root = os.path.dirname(os.path.dirname(
            os.path.dirname(os.path.abspath(__file__))))
        env["PYTHONPATH"] = repo_root + os.pathsep + env.get("PYTHONPATH", "")
        try:
            for i in range(n_workers):
                out = subprocess.DEVNULL
                if log_dir is not None:
                    os.makedirs(log_dir, exist_ok=True)
                    out = open(os.path.join(log_dir, f"worker-{i}.log"), "w")
                    self._logs.append(out)
                p = subprocess.Popen(
                    [sys.executable, "-m", "presto1_tpu_torch.server.worker",
                     "--catalog", catalog_spec, "--device", self.device,
                     "--parent-pid", str(os.getpid()),
                     "--coordinator",
                     f"http://127.0.0.1:{self.discovery.port}"],
                    env=env, stdout=out, stderr=subprocess.STDOUT,
                    stdin=subprocess.DEVNULL)
                self.workers.append(p)
            self._wait_for_nodes(n_workers, START_TIMEOUT_S)
            from ..server.worker import _make_catalog

            catalog = _make_catalog(catalog_spec, device)
            self.engine = MultiHostEngine(
                catalog, self.registry, shards_per_node=shards_per_node,
                broadcast_threshold=broadcast_threshold, device=device)
        except BaseException:
            self.close()
            raise

    def _wait_for_nodes(self, n: int, timeout_s: float) -> None:
        deadline = time.time() + timeout_s
        while time.time() < deadline:
            if len(self.registry.active_nodes()) >= n:
                return
            dead = [p.returncode for p in self.workers
                    if p.poll() is not None]
            if dead:
                raise RuntimeError(
                    f"a worker process exited at start (exit codes {dead})")
            time.sleep(0.1)
        raise TimeoutError(
            f"only {len(self.registry.active_nodes())}/{n} workers announced "
            f"within {timeout_s:.0f} s")

    def sql(self, sql: str, info: Optional[dict] = None):
        return self.engine.sql(sql, info=info)

    def sql_pandas(self, sql: str):
        return self.engine.sql_pandas(sql)

    def kill_worker(self, index: int) -> None:
        """Fault injection: hard-kill one worker process by exact PID."""
        self.workers[index].kill()
        self.workers[index].wait(timeout=30)

    def close(self) -> None:
        for p in self.workers:
            if p.poll() is None:
                p.kill()
            try:
                p.wait(timeout=30)
            except subprocess.TimeoutExpired:
                pass
        for f in self._logs:
            f.close()
        self._logs = []
        self.registry.stop()
        self.discovery.stop()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
