"""Node discovery + heartbeat failure detection (coordinator side).

The reference embeds an airlift discovery service in the coordinator
(``server/Server.java:87``, ``metadata/DiscoveryNodeManager``) and runs
``HeartbeatFailureDetector`` (``failuredetector/HeartbeatFailureDetector.java:
78,318-351``) — a prober that pings every discovered service on an interval
and tracks an exponentially-decayed success rate; nodes under threshold are
excluded by the scheduler.  Same design here over plain HTTP:

* workers PUT /v1/announcement/{nodeId} on a loop → NodeRegistry
  (``serve_discovery``: the coordinator's endpoint, which also lists the
  nodes at GET /v1/node; with a shared secret both ask for its bearer)
* a prober thread GETs each node's /v1/status; success-rate decays with
  factor DECAY per probe; below FAIL_RATIO ⇒ node marked failed
* the scheduler asks for ``active_nodes()`` (announced, not failed,
  not shutting down)

Like the reference (SURVEY §5.3), there is NO intra-query task retry: a
task failure fails the query; failed nodes are only excluded from new
queries.
"""

from __future__ import annotations

import json
import threading
import time
from typing import Dict, List, Optional
from urllib import request as urlrequest


class NodeInfo:
    def __init__(self, node_id: str, uri: str, catalog: str,
                 topology: Optional[dict] = None):
        self.node_id = node_id
        self.uri = uri
        self.catalog = catalog
        # network-locality labels (rack/host/pod ...), announced by the
        # worker (P1_NODE_RACK / P1_NODE_HOST env) — consumed by the
        # TopologyAwareNodeSelector (FlatNetworkTopology analog)
        self.topology: dict = topology or {}
        self.last_announce = time.time()
        self.success_rate = 1.0
        self.last_probe: Optional[float] = None
        self.shutting_down = False

    def info(self) -> dict:
        return {
            "nodeId": self.node_id, "uri": self.uri,
            "catalog": self.catalog,
            "topology": self.topology,
            "successRate": round(self.success_rate, 4),
            "shuttingDown": self.shutting_down,
            "ageSinceAnnounce_s": time.time() - self.last_announce,
        }


class NodeRegistry:
    """Announcement store + heartbeat prober."""

    DECAY = 0.8          # per-probe exponential decay weight
    FAIL_RATIO = 0.4     # below this success rate ⇒ failed
    ANNOUNCE_TTL_S = 30  # nodes silent this long are dropped entirely

    def __init__(self, probe_interval_s: float = 0.5):
        self.nodes: Dict[str, NodeInfo] = {}
        self.lock = threading.Lock()
        self.probe_interval_s = probe_interval_s
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None

    def announce(self, node_id: str, uri: str, catalog: str,
                 topology: Optional[dict] = None) -> None:
        with self.lock:
            node = self.nodes.get(node_id)
            if node is None:
                self.nodes[node_id] = node = NodeInfo(node_id, uri, catalog,
                                                      topology)
            node.uri = uri
            if topology:
                node.topology = topology
            node.last_announce = time.time()

    def active_nodes(self) -> List[NodeInfo]:
        with self.lock:
            return [
                n for n in self.nodes.values()
                if n.success_rate >= self.FAIL_RATIO
                and not n.shutting_down
                and time.time() - n.last_announce < self.ANNOUNCE_TTL_S
            ]

    def all_nodes(self) -> List[NodeInfo]:
        with self.lock:
            return list(self.nodes.values())

    def start(self) -> "NodeRegistry":
        self._thread = threading.Thread(target=self._probe_loop, daemon=True)
        self._thread.start()
        return self

    def stop(self) -> None:
        """Stop the prober and wait for it (bounded): a prober thread still
        running when the interpreter exits can abort the process."""
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=10)

    def _probe_loop(self) -> None:
        while not self._stop.is_set():
            for node in self.all_nodes():
                ok = False
                shutting_down = False
                try:
                    with urlrequest.urlopen(f"{node.uri}/v1/status",
                                            timeout=2) as resp:
                        status = json.loads(resp.read().decode())
                    ok = True
                    shutting_down = status.get("state") == "SHUTTING_DOWN"
                except Exception:  # noqa: BLE001 — a failed probe IS the signal
                    ok = False
                with self.lock:
                    node.success_rate = (self.DECAY * node.success_rate
                                         + (1 - self.DECAY) * (1.0 if ok else 0.0))
                    node.last_probe = time.time()
                    node.shutting_down = shutting_down
            self._stop.wait(self.probe_interval_s)


def serve_discovery(registry: NodeRegistry, handler, method: str,
                    secret: Optional[str] = None) -> bool:
    """Answer ``handler``'s request (a ``BaseHTTPRequestHandler``) where it
    is discovery's: ``PUT /v1/announcement/{nodeId}`` records a worker's
    announcement (202), ``GET /v1/node`` lists every node's info (200).
    With a ``secret`` (the cluster's shared secret) either is refused (401)
    unless it carries the secret's bearer (``security.internal_ok``).
    False, having answered nothing, for any other request."""
    from .security import internal_ok

    parts = handler.path.strip("/").split("/")
    announcement = method == "PUT" and parts[:2] == ["v1", "announcement"] \
        and len(parts) == 3
    listing = method == "GET" and parts == ["v1", "node"]
    if announcement:  # read whether refused or not: the connection stays
        length = int(handler.headers.get("Content-Length", "0"))
        raw = handler.rfile.read(length)
    if (announcement or listing) \
            and not internal_ok(handler.headers, secret):
        code, payload = 401, b'{"error": "internal authentication failed"}'
    elif announcement:
        body = json.loads(raw.decode())
        registry.announce(parts[2], body["uri"], body.get("catalog", ""),
                          topology=body.get("topology"))
        code, payload = 202, b'{"ok": true}'
    elif listing:
        code, payload = 200, json.dumps(
            [n.info() for n in registry.all_nodes()]).encode()
    else:
        return False
    handler.send_response(code)
    handler.send_header("Content-Type", "application/json")
    handler.send_header("Content-Length", str(len(payload)))
    handler.end_headers()
    handler.wfile.write(payload)
    return True


class Backoff:
    """Retry budget for worker RPCs (``server/remotetask/Backoff.java:67``):
    at least MIN_TRIES attempts, give up after max_failure_s of continuous
    failure."""

    MIN_TRIES = 3

    def __init__(self, max_failure_s: float = 10.0):
        self.max_failure_s = max_failure_s
        self.first_failure: Optional[float] = None
        self.tries = 0

    def failure(self) -> bool:
        """Record a failure; returns True if the budget is exhausted."""
        self.tries += 1
        now = time.time()
        if self.first_failure is None:
            self.first_failure = now
        return (self.tries >= self.MIN_TRIES
                and now - self.first_failure > self.max_failure_s)

    def success(self) -> None:
        self.first_failure = None
        self.tries = 0

    def delay_s(self) -> float:
        return min(0.05 * (2 ** max(self.tries - 1, 0)), 1.0)


class UniformNodeSelector:
    """Round-robin placement over the active set — the reference's
    ``UniformNodeSelector`` (the default when no topology is known)."""

    def order(self, nodes: List[NodeInfo]) -> List[NodeInfo]:
        return list(nodes)


class TopologyAwareNodeSelector:
    """Rack-interleaved placement (``TopologyAwareNodeSelector`` +
    ``FlatNetworkTopology`` analog): consecutive task indexes land in
    DIFFERENT racks, so a stage's tasks — and therefore its output
    buffers — spread across failure/bandwidth domains instead of filling
    one rack first.  Nodes without labels form their own singleton
    domain (mixed clusters degrade gracefully to round-robin)."""

    def __init__(self, label: str = "rack"):
        self.label = label

    def order(self, nodes: List[NodeInfo]) -> List[NodeInfo]:
        from collections import OrderedDict

        racks: "OrderedDict[str, List[NodeInfo]]" = OrderedDict()
        for n in sorted(nodes, key=lambda n: n.node_id):
            key = n.topology.get(self.label) or f"__solo_{n.node_id}"
            racks.setdefault(key, []).append(n)
        out: List[NodeInfo] = []
        queues = list(racks.values())
        i = 0
        while any(queues):
            q = queues[i % len(queues)]
            if q:
                out.append(q.pop(0))
            i += 1
            if i > 10_000_000:  # defensive
                break
        return out


def make_node_selector(nodes: List[NodeInfo]):
    """Topology-aware when any node announced a rack label, else
    uniform (the reference picks via node-scheduler.policy config;
    override with ``P1_NODE_SELECTOR=uniform|topology``)."""
    import os

    pick = os.environ.get("P1_NODE_SELECTOR", "auto")
    if pick == "uniform":
        return UniformNodeSelector()
    if pick == "topology" or any(n.topology.get("rack") for n in nodes):
        return TopologyAwareNodeSelector()
    return UniformNodeSelector()
