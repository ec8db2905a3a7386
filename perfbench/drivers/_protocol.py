"""The processes of the ``protocol`` driver.

The coordinator serves the benchmark's catalog on one device through the
port's ``CoordinatorServer``, over the ``Engine`` that the ``engine``
driver builds (``drivers/engine.py`` ``Driver.build``), made as
``server/config.py::build_coordinator`` makes one: the mix's session
properties on a ``Session`` of the suite's catalog, no memory pool, the
query manager's default concurrency of 4.  The profile, the peak memory and
the card's notes are that driver's too.

    python3 perfbench/drivers/_protocol.py coordinator \\
        --parent-pid <pid> --device cuda:0

A session is one client of the port's ``client/http_client.py`` ``Client``
at its shipped defaults, in a process of its own, as a user's client is.
It times each statement itself on ``time.perf_counter``
(``CLOCK_MONOTONIC``: the clock of every process of the host), from the
call to ``Client.execute`` to its return with the last page's rows.

    python3 perfbench/drivers/_protocol.py session --parent-pid <pid>

(``start`` and ``start_session`` run them so.)  Each reads one JSON request
a line on standard input and answers each with one JSON line on standard
output (anything else the process prints goes to standard error).  Each
exits on ``quit``, at the end of its input, and, as ``server/worker.py
--parent-pid`` does, once its parent is gone.
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


def _popen(*args: str) -> subprocess.Popen:
    return subprocess.Popen(
        [sys.executable, os.path.abspath(__file__), *args, "--parent-pid",
         str(os.getpid())],
        stdin=subprocess.PIPE, stdout=subprocess.PIPE, cwd=ROOT, text=True)


def start(device: str) -> subprocess.Popen:
    """The coordinator, a child process of the caller's on ``device``, its
    requests and replies through pipes."""
    return _popen("coordinator", "--device", device)


def start_session() -> subprocess.Popen:
    """A session, a child process of the caller's."""
    return _popen("session")


def _exit_with(parent: int, interval_s: float = 0.2) -> None:
    """Exit this process once ``parent`` is no longer its parent."""
    while True:
        if os.getppid() != parent:
            os._exit(0)
        time.sleep(interval_s)


class Statements:
    """The coordinator's engine as the program's trace replays it: a
    statement goes through ``Engine.execute_statement``, as the query
    manager sends it (the parse of its text before ``Engine.sql``
    included); everything else is the engine's."""

    def __init__(self, engine):
        object.__setattr__(self, "_engine", engine)

    def sql(self, text: str):
        return self._engine.execute_statement(
            text, user=self._engine.session.user)

    def __getattr__(self, name):
        return getattr(self._engine, name)

    def __setattr__(self, name, value):
        setattr(self._engine, name, value)


class Coordinator:
    def __init__(self, device: str, import_s: float):
        import torch

        self.dev = torch.device(device)
        self.import_s = import_s
        self.driver = None
        self.server = None

    def setup(self, config, cache, columns, session) -> dict:
        from presto1_tpu_torch.server.coordinator import CoordinatorServer

        from perfbench.data.store import Store
        from perfbench.drivers import engine
        from perfbench.harness import Setting

        t0 = time.perf_counter()
        self.driver = engine.Driver(Setting(
            device=self.dev, store=Store(config, cache=cache),
            columns=columns, mix={"session": session}))
        t_upload = self.driver.build(catalog=config["suite"])
        self.server = CoordinatorServer(self.driver.engine, port=0).start()
        return {"port": self.server.port, "pid": os.getpid(),
                "import_s": self.import_s, "upload_s": t_upload - t0,
                "server_s": time.perf_counter() - t_upload}

    def reset_peak(self) -> dict:
        self.driver.reset_peak()
        return {}

    def start_profile(self) -> dict:
        return {"sync_ns": self.driver.start_profile()}

    def stop_profile(self) -> dict:
        """The profile's device events: name, start and end (us on the
        trace's clock), and whether the event is a user annotation."""
        import torch

        cuda = torch.autograd.DeviceType.CUDA
        events = [[ev.name, ev.time_range.start, ev.time_range.end,
                   bool(getattr(ev, "is_user_annotation", False))]
                  for ev in self.driver.stop_profile().events()
                  if ev.device_type == cuda]
        self.driver.prof = None
        return {"events": events}

    def program_trace(self, traced) -> dict:
        """The program-span metrics (``metrics/_program_trace.py``) of the
        traced instances, ``[name, text]`` each, replayed here."""
        from perfbench.harness import Run
        from perfbench.metrics import _program_trace

        insts = [types.SimpleNamespace(name=n, text=t) for n, t in traced]
        return {"metrics": _program_trace._measure(
            Run(engine=Statements(self.driver.engine), traced=insts))}

    def device(self) -> dict:
        return self.driver.device()

    def notes(self) -> dict:
        return self.driver.notes()

    def quit(self) -> dict:
        from perfbench.harness import forbidden_modules

        found = forbidden_modules()
        self.stop()
        return {"forbidden": found}

    def stop(self) -> None:
        if self.server is not None:
            self.server, server = None, self.server
            server.stop()


class ClientSession:
    def __init__(self):
        from presto1_tpu_torch.client.http_client import Client

        class Counting(Client):
            """The port's client, keeping the last reply (the FINISHED
            page) and counting the requests of a statement."""

            requests = 0
            last = None

            def _request(self, method, path, body=None):
                out = super()._request(method, path, body)
                self.requests += 1
                self.last = out
                return out

        self.client_class = Counting
        self.client = None

    def connect(self, url: str) -> dict:
        self.client = self.client_class(url)
        return {}

    def query(self, text: str) -> dict:
        client = self.client
        client.requests = 0
        t0 = time.perf_counter()
        try:
            columns, rows = client.execute(text)
        except Exception as e:  # the driver counts the query as failed
            return {"error": f"{type(e).__name__}: {e}"}
        t1 = time.perf_counter()
        return {"start": t0, "end": t1, "columns": columns, "rows": rows,
                "wall_s": client.last["stats"]["wall_s"],
                "requests": client.requests}

    def quit(self) -> dict:
        from perfbench.harness import forbidden_modules

        return {"forbidden": forbidden_modules()}

    def stop(self) -> None:
        pass


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("role", choices=("coordinator", "session"))
    ap.add_argument("--parent-pid", type=int, required=True)
    ap.add_argument("--device")
    args = ap.parse_args(argv)
    threading.Thread(target=_exit_with, args=(args.parent_pid,),
                     daemon=True).start()
    # replies alone on the standard output
    replies = os.fdopen(os.dup(1), "w")
    os.dup2(2, 1)
    sys.stdout = sys.stderr
    sys.path.insert(0, ROOT)
    if args.role == "coordinator":
        # the program's imports, while the harness reads or makes its
        # columns
        import torch
        import presto1_tpu_torch.exec.engine  # noqa: F401
        import presto1_tpu_torch.server.coordinator  # noqa: F401

        import perfbench.drivers.engine  # noqa: F401

        torch.set_num_threads(1)
        node = Coordinator(args.device, time.perf_counter() - T_START)
    else:
        node = ClientSession()
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
