"""The processes of the ``cluster`` driver: Trino's multi-node deployment.

The coordinator and each worker are the port's own servers, each built from
an ``etc`` directory as the port's launcher builds one
(``server/config.py``: ``ServerConfig.from_etc_dir(etc).build()``); the
driver writes those directories.  The coordinator has
``node-scheduler.include-coordinator=false``: it serves discovery and the
statement protocol, plans, schedules each query's stages as tasks on the
workers that announced themselves, and runs the final stage on its device.
Each session is ``_protocol.py``'s client process, which also hands back the
FINISHED page's ``stats``.

    python3 perfbench/drivers/_cluster.py coordinator \\
        --parent-pid <pid> --device cuda:0
    python3 perfbench/drivers/_cluster.py worker \\
        --parent-pid <pid> --device cuda:0
    python3 perfbench/drivers/_cluster.py session --parent-pid <pid>

(``start`` runs the coordinator and ``WORKERS`` workers so, before the
harness's process imports torch; the driver starts the sessions.)  Each
reads one JSON request a line on standard input and answers each with one
JSON line on standard output; each exits on ``quit``, at the end of its
input, and once its parent is gone.  Each of the coordinator and the
workers profiles its own device work, opening with its own
``harness.PROFILE_LEAD`` spin kernels, so that the driver can set every
process's events onto one clock.
"""

import argparse
import json
import os
import subprocess
import sys
import threading
import time
import traceback
import types

T_START = time.perf_counter()
ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
sys.path.insert(0, ROOT)

from perfbench.drivers._protocol import ClientSession, _exit_with  # noqa: E402

# the workers ``start`` starts: the configuration's ``workers``, which the
# driver checks
WORKERS = 2


def _popen(*args: str) -> subprocess.Popen:
    return subprocess.Popen(
        [sys.executable, os.path.abspath(__file__), *args, "--parent-pid",
         str(os.getpid())],
        stdin=subprocess.PIPE, stdout=subprocess.PIPE, cwd=ROOT, text=True)


class Started:
    """The coordinator's and the workers' processes, started early."""

    def __init__(self, device: str, workers: int = WORKERS):
        self.coordinator = _popen("coordinator", "--device", device)
        self.workers = [_popen("worker", "--device", device)
                        for _ in range(workers)]

    def all(self) -> list:
        return [self.coordinator, *self.workers]

    def kill(self) -> None:
        for p in self.all():
            p.kill()

    def communicate(self) -> None:
        for p in self.all():
            p.communicate()


def start(device: str) -> Started:
    return Started(device)


def start_session() -> subprocess.Popen:
    return _popen("session")


class Node:
    """A server of the port in this process, built from an etc directory,
    with the device's profile and peak memory of this process."""

    def __init__(self, device: str, import_s: float):
        import torch

        self.dev = torch.device(device)
        self.import_s = import_s
        self.server = None
        self.prof = None

    def setup(self, etc: str) -> dict:
        from presto1_tpu_torch.server.config import ServerConfig

        t0 = time.perf_counter()
        cfg = ServerConfig.from_etc_dir(etc)
        cfg.device = str(self.dev)
        self.server = cfg.build().start()
        return {"pid": os.getpid(), "import_s": self.import_s,
                "server_s": time.perf_counter() - t0}

    def reset_peak(self) -> dict:
        import torch

        if self.dev.type == "cuda":
            torch.cuda.reset_peak_memory_stats(self.dev)
        return {}

    def start_profile(self) -> dict:
        import torch
        from torch.profiler import ProfilerActivity, profile

        from perfbench.harness import PROFILE_LEAD

        self.prof = profile(activities=[ProfilerActivity.CUDA])
        self.prof.__enter__()
        for _ in range(PROFILE_LEAD):
            torch.cuda._sleep(1)
        torch.cuda.synchronize(self.dev)
        return {"sync_ns": round(time.perf_counter() * 1e9)}

    def stop_profile(self) -> dict:
        """The profile's device events: name, start and end (us on this
        process's trace clock), and whether each is a user annotation."""
        import torch

        self.prof.__exit__(None, None, None)
        cuda = torch.autograd.DeviceType.CUDA
        events = [[ev.name, ev.time_range.start, ev.time_range.end,
                   bool(getattr(ev, "is_user_annotation", False))]
                  for ev in self.prof.events() if ev.device_type == cuda]
        self.prof = None
        return {"events": events}

    def device(self) -> dict:
        import torch

        if self.dev.type != "cuda":
            return {"kind": self.dev.type, "memory_peak_bytes": 0}
        return {"kind": torch.cuda.get_device_name(self.dev),
                "memory_peak_bytes": int(torch.cuda.max_memory_allocated(
                    self.dev))}

    def quit(self) -> dict:
        from perfbench.harness import forbidden_modules

        found = forbidden_modules()
        self.stop()
        return {"forbidden": found}

    def stop(self) -> None:
        if self.server is not None:
            self.server, server = None, self.server
            server.stop()


class Coordinator(Node):
    def setup(self, etc: str) -> dict:
        out = super().setup(etc)
        return dict(out, port=self.server.port)

    def program_trace(self, traced) -> dict:
        """The cluster's program-span metrics (``metrics/_cluster_trace.py``)
        of the traced instances, ``[name, text]`` each, replayed here
        through the query manager's route."""
        from perfbench.metrics import _cluster_trace

        insts = [types.SimpleNamespace(name=n, text=t) for n, t in traced]
        return {"metrics": _cluster_trace.measure(self.server.manager,
                                                  insts)}

    def notes(self) -> dict:
        from perfbench.harness import copy_rate

        return {"copy_rate_gb_s": copy_rate(self.dev)} \
            if self.dev.type == "cuda" else {}


class Worker(Node):
    def setup(self, etc: str) -> dict:
        out = super().setup(etc)
        return dict(out, node_id=self.server.runtime.node_id,
                    uri=self.server.uri())

    def metrics(self) -> dict:
        """The worker's counters (its ``/v1/metrics``) by name."""
        from presto1_tpu_torch.server.worker import _metrics_snapshot

        return {"counters": {m["name"]: m["total"]
                             for m in _metrics_snapshot()
                             if m["kind"] == "counter"}}


class ClusterSession(ClientSession):
    """``_protocol.py``'s session, which also hands back the FINISHED
    page's ``stats``: the stages, tasks and nodes of the statement."""

    def query(self, text: str) -> dict:
        out = super().query(text)
        if "error" not in out:
            out["stats"] = self.client.last["stats"]
        return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("role", choices=("coordinator", "worker", "session"))
    ap.add_argument("--parent-pid", type=int, required=True)
    ap.add_argument("--device")
    args = ap.parse_args(argv)
    threading.Thread(target=_exit_with, args=(args.parent_pid,),
                     daemon=True).start()
    # replies alone on the standard output
    replies = os.fdopen(os.dup(1), "w")
    os.dup2(2, 1)
    sys.stdout = sys.stderr
    if args.role == "session":
        node = ClusterSession()
    else:
        # the program's imports, while the harness reads or makes its
        # columns
        import torch
        import presto1_tpu_torch.server.coordinator  # noqa: F401
        import presto1_tpu_torch.server.worker  # noqa: F401

        import perfbench.connector  # noqa: F401

        torch.set_num_threads(1)
        role = Coordinator if args.role == "coordinator" else Worker
        node = role(args.device, time.perf_counter() - T_START)
    try:
        for line in sys.stdin:
            request = json.loads(line)
            op = request.pop("op")
            try:
                reply = getattr(node, op)(**request)
            except Exception as e:  # reported to the driver, which fails
                traceback.print_exc()
                reply = {"error": f"{type(e).__name__}: {e}"}
            replies.write(json.dumps(reply) + "\n")
            replies.flush()
            if op == "quit":
                break
    finally:
        node.stop()
    return 0


if __name__ == "__main__":
    sys.exit(main())
