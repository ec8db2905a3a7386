"""The ``cluster`` driver (on the CPU, SF 0.01, without the look for a
card): the cell ``tpch-sf1-cluster.streams`` runs correct with answers in
both sessions, and not correct with the path broken underneath (a value
altered in a worker's ``pages_encode``, half of one worker's shard left
out, a stale answer); a coordinator that runs the statements itself fails
set-up; a run fails where a worker loaded JAX; no process of the driver
outlives a run; the coordinator replays the cluster's trace; the four
readers on a recorded trace."""

import json
import os
import subprocess
import sys
import time

import pytest
import torch

from presto1_tpu_torch.trace import QueryTrace

from perfbench.control import readings
from perfbench.harness import ForbiddenModules, Run, Setting, run
from perfbench.metrics import (_cluster_trace, exchange_mb_per_query,
                               pages_ms_per_query, schedule_ms_per_query,
                               worker_compute_ms_per_query)
from perfbench.traffic import Traffic

from .helpers import SEEDS, SF, mix, store
from .test_perfbench_protocol import plant, stderr_lines

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ROOT = os.path.dirname(HERE)
CELL = "tpch-sf1-cluster.streams"
OVERRIDE = {"scale_factor": SF}

# what each fault plants runs in the process whose role it names
IN_WORKERS = "import sys\nif 'worker' in sys.argv:\n"
FAULTS = {
    "altered_in_pages_encode": IN_WORKERS + """
    import presto1_tpu_torch.exec.pages as pages
    plain = pages.serialize_batch
    def serialize_batch(batch, compress=True):
        for c in batch.columns.values():
            if int(batch.num_rows) and c.data.ndim == 1 \\
                    and c.dictionary is None \\
                    and not c.data.dtype.is_floating_point:
                c.data = c.data.clone()
                c.data[0] += 1
                break
        return plain(batch, compress)
    pages.serialize_batch = serialize_batch
""",
    "half_of_one_shard": IN_WORKERS + """
    from presto1_tpu_torch.exec.catalog import ShardedTable
    plain = ShardedTable.__init__
    def __init__(self, base, index, count):
        plain(self, base, index, count)
        if index == 0:
            self.hi = self.lo + (self.hi - self.lo) // 2
    ShardedTable.__init__ = __init__
""",
    "stale": """
from presto1_tpu_torch.client.http_client import Client
plain = Client.execute
def execute(self, sql, *a, **k):
    out = getattr(self, "stale", None)
    self.stale = plain(self, sql, *a, **k)
    return out if out is not None else self.stale
Client.execute = execute
""",
}
LOCAL = """
import sys
if 'coordinator' in sys.argv:
    from presto1_tpu_torch.server.coordinator import QueryManager
    def execute(self, sql, user, stats=None, cluster_stats=None):
        return self.engine.execute_statement(sql, user=user, stats=stats)
    QueryManager.execute = execute
"""
JAX_IN_A_WORKER = IN_WORKERS + """
    import types
    sys.modules["jax"] = types.ModuleType("jax")
"""


def cell_run(seconds: float = 2.0, seed: int = 2 ** 31 + 17) -> dict:
    return run(CELL, seed, seconds, False, device="cpu",
               config_override=OVERRIDE, data_cache=None)


@pytest.mark.parametrize("fault", ["none", *FAULTS])
def test_cluster_cell(fault, monkeypatch, capsys, tmp_path):
    if fault != "none":
        plant(monkeypatch, tmp_path, FAULTS[fault])
    out = cell_run()
    assert out["correct"] is (fault == "none"), out["checks"]
    assert set(out["metrics"]) == {"queries_per_s", "geomean_ms",
                                   "setup_s"}
    err = capsys.readouterr().err
    sessions = stderr_lines(err, "sessions")[-1]
    assert len(sessions["queries"]) == mix("streams")["sessions"] == 2
    assert all(n > 0 for n in sessions["queries"]), sessions
    if fault == "none":
        assert sessions["right"] == sessions["queries"]
        numbers = stderr_lines(err, "numbers")[-1]
        assert numbers["tasks"] >= 2 and numbers["exchange_bytes"] > 0


def test_a_coordinator_that_runs_the_statements_itself_fails_setup(
        monkeypatch, tmp_path):
    plant(monkeypatch, tmp_path, LOCAL)
    with pytest.raises(RuntimeError, match="not on each of the workers"):
        cell_run()


def test_a_worker_that_loads_jax_fails_the_run(monkeypatch, tmp_path):
    """What ``perfbench/run.py`` reports with exit code 3."""
    plant(monkeypatch, tmp_path, JAX_IN_A_WORKER)
    with pytest.raises(ForbiddenModules, match="jax"):
        cell_run(1.0)


def _gone(pid: int) -> bool:
    """No process ``pid`` runs the driver's module (a zombie has ended)."""
    try:
        with open(f"/proc/{pid}/cmdline") as f:
            cmd = f.read()
        with open(f"/proc/{pid}/stat") as f:
            state = f.read().rsplit(")", 1)[1].split()[0]
    except FileNotFoundError:
        return True
    return state == "Z" or "_cluster.py" not in cmd


@pytest.mark.parametrize("end", ["closes", "killed"])
def test_no_process_of_the_driver_outlives_the_run(end):
    seconds = 1.0 if end == "closes" else 300.0
    code = (
        "import sys; sys.path.insert(0, %r)\n"
        "from perfbench.harness import run\n"
        "out = run(%r, 5, %r, False, device='cpu',\n"
        "          config_override={'scale_factor': %r}, data_cache=None)\n"
        "assert out['correct'], out\n" % (ROOT, CELL, seconds, SF))
    p = subprocess.Popen([sys.executable, "-c", code], text=True,
                         stderr=subprocess.PIPE, stdout=subprocess.DEVNULL)
    pids = None
    try:
        for line in p.stderr:
            if line.startswith('{"coordinator": {"pid"') and pids is None:
                d = json.loads(line)
                pids = [d["coordinator"]["pid"], *d["worker_pids"],
                        *d["session_pids"]]
            if line.startswith('{"setup"'):
                break
        assert pids is not None and len(pids) == 5
        assert not any(map(_gone, pids))
        if end == "killed":
            p.kill()
        p.stderr.read()
        assert p.wait(timeout=120) == (-9 if end == "killed" else 0)
        deadline = time.monotonic() + 10
        while not all(map(_gone, pids)) and time.monotonic() < deadline:
            time.sleep(0.1)
        assert all(map(_gone, pids))
    finally:
        if p.poll() is None:
            p.kill()
            p.wait()


def test_the_coordinator_replays_the_clusters_trace():
    """The four metrics, read in the coordinator over the query manager's
    route, each statement's workers' spans grafted into its trace."""
    from perfbench.data.store import Store
    from perfbench.drivers.cluster import Driver

    with open(os.path.join(HERE, "configs", "tpch-sf1-cluster.json")) as f:
        config = dict(json.load(f), **OVERRIDE, name="tpch-sf1-cluster")
    m = mix("streams")
    traffic = Traffic(m, "tpch", 3)
    setting = Setting(device=torch.device("cpu"), config=config, cache=None,
                      mix=m, sessions=2, started=None)
    setting.store = Store(config, cache=None)
    setting.traffic = traffic
    setting.columns = traffic.columns()
    driver = Driver(setting)
    try:
        driver.setup()
        got = driver.program_trace(traffic.instances[:6])
    finally:
        assert driver.close() == []
    assert set(got) == {"pages_ms_per_query", "exchange_mb_per_query",
                        "worker_compute_ms_per_query",
                        "schedule_ms_per_query"}
    assert all(v > 0 for v in got.values()), got


def recorded() -> QueryTrace:
    """A statement as the coordinator records one: two stages, a task of
    each on a worker, one page pull (times in ns)."""
    t = QueryTrace("q")
    t.spans = [
        ["statement", 0, 1000, None, None],
        ["stage_dag", 10, 20, 0, None],
        ["schedule", 20, 100, 0, {"stage": 1}],
        ["schedule", 25, 60, 2, {"stage": 0}],
        ["task_create", 30, 55, 3, {"node": "a"}],
        ["task_create", 60, 95, 2, {"node": "b"}],
        ["gather", 100, 800, 0, None],
        ["task_wait", 800, 850, 0, {"tasks": 2}],
        ["execute", 850, 990, 0, None],
        ["op:Output", 860, 980, 8, 1],
    ]
    # the pull thread's spans, then each task's
    t.graft(6, [["fetch_pages", 110, 700, None, {"pages": 1, "bytes": 9}],
                ["pages_decode", 700, 760, None, {"bytes": 9, "rows": 3}]])
    t.graft(3, [["task", 50, 500, None, {"node": "a"}],
                ["run", 60, 300, 0, None],
                ["fragment", 70, 250, 1, ""],
                ["op:Aggregate", 80, 240, 2, 1],
                ["wait", 260, 290, 1, 16],
                ["partition_output", 300, 450, 0, {"rows": 3}],
                ["pages_encode", 400, 440, 5, {"pages": 2, "bytes": 2000000,
                                               "raw_bytes": 4000000}]])
    t.graft(2, [["task", 100, 750, None, {"node": "b"}],
                ["task_fetch", 110, 500, 0, {"pages": 2, "bytes": 3}],
                ["pages_decode", 450, 500, 1, {"bytes": 3, "rows": 3}],
                ["op:Aggregate", 510, 600, 0, 2],
                ["pages_encode", 600, 700, 0, {"pages": 1, "bytes": 500000,
                                               "raw_bytes": 600000}]])
    return t


def test_the_four_readers_on_a_recorded_trace():
    m = _cluster_trace.statement(recorded())["metrics"]
    # partition_output 150 - 40, pages_encode 40 + 100, pages_decode 60 + 50
    assert m["pages_ms_per_query"] == pytest.approx(360 / 1e6)
    assert m["exchange_mb_per_query"] == pytest.approx(2.5)
    # run 240 - 180 - 30, fragment 180 - 160, op:Aggregate 160 + 90, wait 30
    assert m["worker_compute_ms_per_query"] == pytest.approx(330 / 1e6)
    # stage_dag 10, schedule (80 - 35 - 35) + (35 - 25), task_create 25 + 35,
    # task_wait 50: the coordinator's op:Output is not a worker's
    assert m["schedule_ms_per_query"] == pytest.approx(140 / 1e6)
    ctx = Run(_program_trace=m)
    for reader in (pages_ms_per_query, exchange_mb_per_query,
                   worker_compute_ms_per_query, schedule_ms_per_query):
        name = reader.__name__.rsplit(".", 1)[1]
        assert reader.read(ctx) == m[name]
        # a program that keeps no such trace: nothing to read
        assert reader.read(Run()) is None
        assert reader.read(Run(_program_trace=None)) is None


@pytest.mark.parametrize("seed", (None,) + SEEDS)
def test_control_is_not_correct(seed):
    """The reference in the nearest lower precision fails the cell's
    comparison (its limits are the protocol cell's, over the same data)."""
    r = readings(Traffic(mix("streams"), "tpch", seed or 0,
                         instance_seed=seed), store("tpch-sf1"))
    with open(os.path.join(HERE, "configs", "tpch-sf1-cluster.json")) as f:
        lim = json.load(f)["limits"]
    assert r["wrong_answers"] > lim["wrong_answers"] \
        or r["double_rel_err"] > lim["double_rel_err"], r
