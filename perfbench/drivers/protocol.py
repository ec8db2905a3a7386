"""The statement-protocol layout: Trino's single-node deployment
(``coordinator=true``, ``node-scheduler.include-coordinator=true``).  One
coordinator process on the device serves the benchmark's catalog through
the port's ``CoordinatorServer`` (``_protocol.py``, started before the
harness's process imports torch where ``perfbench/run.py`` runs the cell);
each session is a process of its own with a client of the port's
``client/http_client.py`` ``Client`` at its shipped defaults.  The
harness's process does not touch the device.

A query is timed by its session's process, from the call to
``Client.execute(text)`` to its return, when the last page's rows are in
the session's list; the harness's own work on the answer falls outside.
Its numbers are the coordinator's own ``stats.wall_s`` on the FINISHED page
(``QueryManager._run``: the statement, the decode and the JSON rows) and
the requests the client made.

Answers arrive as JSON values.  ``wire_rows`` turns them back, once, into
what ``reference/common.py::judge`` compares: a DATE column's ISO text
becomes a ``datetime.date`` (which ``normal`` counts in days); every other
value is kept as it came (a DECIMAL or DOUBLE as the float that the
coordinator's ``Column.decode`` gave and JSON carries to the last bit, a
BIGINT as an int, a VARCHAR as text).  A DATE value that is not ISO text is
kept as it came, and so compares unequal.
"""

from __future__ import annotations

import datetime
import json
import subprocess
import time
import types

import torch

from ..harness import ForbiddenModules, log
from ._protocol import start, start_session


class Process:
    """A process of the driver, asked one JSON request at a time."""

    def __init__(self, name: str, proc: subprocess.Popen):
        self.name, self.proc = name, proc

    def ask(self, op: str, **kv) -> dict:
        self.proc.stdin.write(json.dumps({"op": op, **kv}) + "\n")
        self.proc.stdin.flush()
        line = self.proc.stdout.readline()
        if not line:
            raise RuntimeError(f"the {self.name} exited "
                               f"(code {self.proc.wait()}) at {op!r}")
        reply = json.loads(line)
        if "error" in reply:
            raise RuntimeError(f"the {self.name} at {op!r}: "
                               f"{reply['error']}")
        return reply

    def quit(self) -> list:
        """The forbidden modules the process reports as it stops; raises
        where it does not report them.  The process has ended on return."""
        try:
            if self.proc.poll() is not None:
                raise RuntimeError(f"the {self.name} had exited "
                                   f"(code {self.proc.returncode})")
            found = self.ask("quit")["forbidden"]
            self.proc.wait(timeout=60)
            return found
        finally:
            if self.proc.poll() is None:
                self.proc.kill()
            self.proc.communicate()


def wire_rows(columns, rows) -> list:
    dates = [j for j, c in enumerate(columns) if c["type"] == "date"]
    if not dates:
        return rows
    out = []
    for row in rows:
        row = list(row)
        for j in dates:
            if isinstance(row[j], str):
                try:
                    row[j] = datetime.date.fromisoformat(row[j])
                except ValueError:
                    pass
        out.append(row)
    return out


class Driver:
    PART = "client"
    engine = None

    def __init__(self, setting):
        self.setting = setting
        self.closed = False
        self.coordinator = Process(
            "coordinator", setting.started or start(str(setting.device)))
        self.sessions = [Process(f"session {k}", start_session())
                         for k in range(setting.sessions)]
        log(coordinator={"pid": self.coordinator.proc.pid},
            session_pids=[p.proc.pid for p in self.sessions])

    def setup(self) -> dict:
        s = self.setting
        t0 = time.perf_counter()
        node = self.coordinator.ask(
            "setup", config=s.config, cache=s.cache, columns=s.columns,
            session=s.mix["session"])
        t_up = time.perf_counter()
        url = f"http://127.0.0.1:{node.pop('port')}"
        for p in self.sessions:
            p.ask("connect", url=url)
        self.warm()
        t_compile = time.perf_counter()
        self.warm()
        t_warm = time.perf_counter()
        self.coordinator.ask("reset_peak")
        log(coordinator=node)
        return {"coordinator_s": t_up - t0, "compile_s": t_compile - t_up,
                "warm_s": t_warm - t_compile}

    def warm(self) -> None:
        """One call of every text, the sessions taking them in turn."""
        for k, inst in enumerate(self.setting.traffic.instances):
            self.sessions[k % len(self.sessions)].ask("query",
                                                      text=inst.text)

    def query(self, session: int, text: str, parts):
        return self.sessions[session].ask("query", text=text)

    def answer(self, reply):
        return wire_rows(reply["columns"], reply["rows"]), \
            {"server_wall_s": reply["wall_s"],
             "requests": reply["requests"]}, (reply["start"], reply["end"])

    def start_profile(self) -> int:
        return self.coordinator.ask("start_profile")["sync_ns"]

    def stop_profile(self):
        cuda = torch.autograd.DeviceType.CUDA
        events = [types.SimpleNamespace(
            name=name, device_type=cuda, is_user_annotation=note,
            time_range=types.SimpleNamespace(start=a, end=b))
            for name, a, b, note in self.coordinator.ask(
                "stop_profile")["events"]]
        return types.SimpleNamespace(events=lambda: events)

    def program_trace(self, instances):
        """The program-span metrics of ``instances``, replayed in the
        coordinator on its own engine (None where its program keeps no
        trace)."""
        return self.coordinator.ask(
            "program_trace",
            traced=[[i.name, i.text] for i in instances])["metrics"]

    def device(self) -> dict:
        return self.coordinator.ask("device")

    def notes(self) -> dict:
        return self.coordinator.ask("notes")

    def close(self) -> list:
        """Asks every process to stop and to name the forbidden modules it
        had loaded, and ends it where it does not.  Raises
        ``ForbiddenModules`` where a process did not name them: the run
        then cannot say that none was loaded."""
        if self.closed:
            return []
        self.closed = True
        found, unknown = set(), []
        for p in [*self.sessions, self.coordinator]:
            try:
                found.update(p.quit())
            except (OSError, RuntimeError, ValueError,
                    subprocess.TimeoutExpired) as e:
                unknown.append(f"{p.name}: {e!r}")
        if unknown:
            raise ForbiddenModules(
                f"no report of the loaded modules from {unknown}")
        return sorted(found)
