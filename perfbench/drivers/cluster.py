"""The multi-node layout: Trino's deployment of a coordinator
(``coordinator=true``, ``node-scheduler.include-coordinator=false``) and
the configuration's ``workers`` (``coordinator=false``), each node
``discovery.uri`` pointing at the coordinator and reading the same
``etc/catalog``: the benchmark's columns through the connector that
``perfbench/connector.py`` names by its factory, so that every node and the
reference read the same arrays.  The processes are ``_cluster.py``'s,
started before the harness's process imports torch where
``perfbench/run.py`` runs the cell; each session is a client process of the
port's ``Client`` at its shipped defaults, as in the ``protocol`` layout
(``protocol.py``: the timing, the answers as JSON values).

Set-up waits, for at most ``ANNOUNCE_TIMEOUT_S``, until every worker is
listed by the coordinator's ``GET /v1/node``, then sends every text
``WARM_PASSES`` times and checks that each statement's FINISHED ``stats``
name tasks on every worker: a coordinator that runs a query itself, or a
worker that takes no task, fails the run there.  The traced run's profile
covers every process of the card: each opens with its own spin kernels,
which set its events onto the coordinator's trace clock.  The program's
trace is replayed in the coordinator, through its query manager's route
(``metrics/_cluster_trace.py``).
"""

from __future__ import annotations

import json
import os
import shutil
import subprocess
import tempfile
import time
import types
import urllib.request
from concurrent.futures import ThreadPoolExecutor

import torch

from ..harness import ForbiddenModules, log
from . import protocol
from ._cluster import start, start_session

# a worker announces itself once torch is imported and its server listens
ANNOUNCE_TIMEOUT_S = 120.0
# calls of every text in set-up: a worker compiles a fragment on its first
# or second sighting, and its CUDA graph is captured on the call after
WARM_PASSES = 3


def properties(values: dict) -> str:
    return "".join(f"{k}={v}\n" for k, v in values.items())


def ask_all(procs, op: str) -> list:
    """``op`` asked of every process at once, the replies in order (each
    process does its part, a profile's processing say, beside the rest)."""
    with ThreadPoolExecutor(max_workers=len(procs)) as pool:
        return list(pool.map(lambda p: p.ask(op), procs))


class Driver(protocol.Driver):
    def __init__(self, setting):
        self.setting = setting
        self.closed = False
        n = setting.config["workers"]
        early = setting.started or start(str(setting.device))
        if len(early.workers) != n:
            early.kill()
            early.communicate()
            raise ValueError(f"{len(early.workers)} worker processes "
                             f"started, the configuration has {n}")
        self.coordinator = protocol.Process("coordinator", early.coordinator)
        self.workers = [protocol.Process(f"worker {k}", p)
                        for k, p in enumerate(early.workers)]
        self.sessions = [protocol.Process(f"session {k}", start_session())
                         for k in range(setting.sessions)]
        self.etc = tempfile.mkdtemp(prefix="cluster-etc-")
        self.node_ids: list = []
        self.syncs: list = []
        log(coordinator={"pid": self.coordinator.proc.pid},
            worker_pids=[p.proc.pid for p in self.workers],
            session_pids=[p.proc.pid for p in self.sessions])

    def nodes(self) -> list:
        return [self.coordinator, *self.workers]

    def write_etc(self, name: str, config: dict) -> str:
        """An etc directory: ``config.properties`` and the one catalog,
        ``catalog/<suite>.properties``."""
        s = self.setting
        etc = os.path.join(self.etc, name)
        os.makedirs(os.path.join(etc, "catalog"))
        with open(os.path.join(etc, "config.properties"), "w") as f:
            f.write(properties(config))
        catalog = {"connector.name": "perfbench.connector:create",
                   "bench.config-file": os.path.join(self.etc,
                                                     "config.json")}
        if s.cache is not None:
            catalog["bench.cache-dir"] = s.cache
        with open(os.path.join(etc, "catalog", s.config["suite"]
                               + ".properties"), "w") as f:
            f.write(properties(catalog))
        return etc

    def setup(self) -> dict:
        s = self.setting
        t0 = time.perf_counter()
        with open(os.path.join(self.etc, "config.json"), "w") as f:
            json.dump(s.config, f)
        node = self.coordinator.ask("setup", etc=self.write_etc(
            "coordinator", {"coordinator": "true",
                            "node-scheduler.include-coordinator": "false",
                            "http-server.http.port": 0,
                            **s.mix["session"]}))
        url = f"http://127.0.0.1:{node.pop('port')}"
        workers = []
        for k, w in enumerate(self.workers):
            workers.append(w.ask("setup", etc=self.write_etc(
                f"worker-{k}", {"coordinator": "false",
                                "http-server.http.port": 0,
                                "discovery.uri": url})))
        self.node_ids = [w["node_id"] for w in workers]
        self.wait_for_workers(url)
        t_up = time.perf_counter()
        for p in self.sessions:
            p.ask("connect", url=url)
        self.warm()
        t_compile = time.perf_counter()
        for _ in range(WARM_PASSES - 1):
            self.warm()
        t_warm = time.perf_counter()
        ask_all(self.nodes(), "reset_peak")
        log(coordinator=node, workers=workers)
        return {"cluster_s": t_up - t0, "compile_s": t_compile - t_up,
                "warm_s": t_warm - t_compile}

    def wait_for_workers(self, url: str) -> None:
        """Until the coordinator lists every worker; raises where one has
        exited or ``ANNOUNCE_TIMEOUT_S`` has passed."""
        deadline = time.monotonic() + ANNOUNCE_TIMEOUT_S
        while True:
            with urllib.request.urlopen(url + "/v1/node", timeout=10) as r:
                listed = {n["nodeId"] for n in json.load(r)}
            if listed >= set(self.node_ids):
                return
            gone = [p.name for p in self.workers if p.proc.poll() is not None]
            if gone or time.monotonic() > deadline:
                missing = sorted(set(self.node_ids) - listed)
                why = f"exited: {gone}" if gone else "timed out"
                raise RuntimeError(f"workers not announced: {missing} "
                                   f"({why})")
            time.sleep(0.1)

    def warm(self) -> None:
        """One call of every text, the sessions taking them in turn; each
        statement has to have run as tasks on every worker."""
        for k, inst in enumerate(self.setting.traffic.instances):
            reply = self.sessions[k % len(self.sessions)].ask(
                "query", text=inst.text)
            ran = reply["stats"].get("nodes") or {}
            if set(ran) != set(self.node_ids):
                raise RuntimeError(
                    f"{inst.name}: the statement's tasks ran on {sorted(ran)}"
                    f", not on each of the workers {self.node_ids}")

    def answer(self, reply):
        rows, numbers, times = super().answer(reply)
        stats = reply["stats"]
        numbers.update(tasks=stats["tasks"],
                       exchange_bytes=stats["exchange_bytes"],
                       coordinator_bytes=stats["coordinator_bytes"])
        return rows, numbers, times

    def start_profile(self) -> int:
        self.syncs = [p.ask("start_profile")["sync_ns"]
                      for p in self.nodes()]
        return self.syncs[0]

    def stop_profile(self):
        """Every process's device events on the coordinator's trace clock:
        a process's spin kernels end just before its synchronize returned
        at its ``sync_ns`` (the host's clock), which sets its events onto
        the host's clock and from there onto the coordinator's.  The
        workers' spin kernels are left out."""
        cuda = torch.autograd.DeviceType.CUDA
        offsets, per = [], []
        for got, sync in zip(ask_all(self.nodes(), "stop_profile"),
                             self.syncs):
            events = got["events"]
            spins = [b for name, _, b, _ in events if "spin_kernel" in name]
            offsets.append(None if not spins else sync - max(spins) * 1e3)
            per.append(events)
        events = []
        for k, evs in enumerate(per):
            shift = 0.0
            if k:
                if offsets[0] is None or offsets[k] is None:
                    log(profile_unaligned=self.nodes()[k].name)
                else:
                    shift = (offsets[k] - offsets[0]) / 1e3
                evs = [e for e in evs if "spin_kernel" not in e[0]]
            events += [types.SimpleNamespace(
                name=name, device_type=cuda, is_user_annotation=note,
                time_range=types.SimpleNamespace(start=a + shift,
                                                 end=b + shift))
                for name, a, b, note in evs]
        return types.SimpleNamespace(events=lambda: events)

    def device(self) -> dict:
        """The card's name, and the sum of every process's peak (each
        process's on standard error)."""
        got = ask_all(self.nodes(), "device")
        log(memory_peak_bytes={p.name: g["memory_peak_bytes"]
                               for p, g in zip(self.nodes(), got)})
        return {"kind": got[0]["kind"],
                "memory_peak_bytes": sum(g["memory_peak_bytes"]
                                         for g in got)}

    def notes(self) -> dict:
        return {**self.coordinator.ask("notes"),
                "worker_counters": {p.name: p.ask("metrics")["counters"]
                                    for p in self.workers}}

    def close(self) -> list:
        """Asks every process to stop and to name the forbidden modules it
        had loaded, and ends it where it does not; raises
        ``ForbiddenModules`` where a process did not name them."""
        if self.closed:
            return []
        self.closed = True
        found, unknown = set(), []
        for p in [*self.sessions, *self.workers, self.coordinator]:
            try:
                found.update(p.quit())
            except (OSError, RuntimeError, ValueError,
                    subprocess.TimeoutExpired) as e:
                unknown.append(f"{p.name}: {e!r}")
        shutil.rmtree(self.etc, ignore_errors=True)
        if unknown:
            raise ForbiddenModules(
                f"no report of the loaded modules from {unknown}")
        return sorted(found)
