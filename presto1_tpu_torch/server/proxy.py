"""Statement-protocol proxy / load balancer (service/trino-proxy analog).

Reference: ``service/trino-proxy`` (902 LoC) forwards the REST statement
protocol to a backing cluster and rewrites nextUri links so clients keep
talking to the proxy.  This does the same over the presto1 protocol:
POST /v1/statement round-robins across configured coordinators; the query
id is remembered so follow-up GET/DELETE polls route to the coordinator
that owns the query.  Responses pass through verbatim (nextUri paths are
host-relative in this protocol, so no rewriting is needed).
"""

from __future__ import annotations

import itertools
import json
import threading
import urllib.request
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Dict, List


class ProxyServer:
    def __init__(self, backends: List[str], host: str = "127.0.0.1",
                 port: int = 0):
        """backends: base URLs, e.g. ["http://127.0.0.1:8081", ...]."""
        self.backends = list(backends)
        rr = itertools.cycle(range(len(self.backends)))
        owners: Dict[str, str] = {}  # query id -> backend base url
        lock = threading.Lock()
        proxy = self

        class Handler(BaseHTTPRequestHandler):
            protocol_version = "HTTP/1.1"

            def log_message(self, fmt, *args):
                pass

            def _relay(self, base: str, body=None):
                req = urllib.request.Request(
                    base + self.path, data=body, method=self.command)
                for h in ("X-Presto1-User", "X-Presto1-Schema",
                          "Authorization", "Content-Type"):
                    if self.headers.get(h):
                        req.add_header(h, self.headers[h])
                try:
                    with urllib.request.urlopen(req, timeout=3600) as resp:
                        data = resp.read()
                        code = resp.status
                except urllib.error.HTTPError as e:
                    data = e.read()
                    code = e.code
                self.send_response(code)
                self.send_header("Content-Type", "application/json")
                self.send_header("Content-Length", str(len(data)))
                self.end_headers()
                self.wfile.write(data)
                return data, code

            def do_POST(self):
                length = int(self.headers.get("Content-Length", "0"))
                body = self.rfile.read(length)
                with lock:
                    base = proxy.backends[next(rr)]
                data, code = self._relay(base, body)
                if code == 200:
                    try:
                        qid = json.loads(data).get("id")
                        if qid:
                            with lock:
                                owners[qid] = base
                    except Exception:
                        pass

            def _owner(self) -> str:
                parts = self.path.strip("/").split("/")
                for p in parts:
                    with lock:
                        if p in owners:
                            return owners[p]
                with lock:
                    return proxy.backends[0]

            def do_GET(self):
                self._relay(self._owner())

            def do_DELETE(self):
                self._relay(self._owner())

        self._httpd = ThreadingHTTPServer((host, port), Handler)
        self.host = host
        self.port = self._httpd.server_address[1]
        self._thread = threading.Thread(
            target=self._httpd.serve_forever, daemon=True)

    def start(self) -> "ProxyServer":
        self._thread.start()
        return self

    def stop(self) -> None:
        self._httpd.shutdown()
        self._httpd.server_close()
