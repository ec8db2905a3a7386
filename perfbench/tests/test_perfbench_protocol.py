"""The ``protocol`` driver and the harness's sessions (on the CPU, SF 0.01,
without the look for a card): the cell ``tpch-sf1-streams.protocol`` runs
correct with answers in both sessions, and not correct with the timed
path broken underneath (a value altered where the coordinator makes its
JSON rows or on the wire, a stale answer, half of every table's rows left
out of the coordinator's scans); a run fails where a process of the driver
loaded JAX or does not say what it loaded; no process of the driver
outlives a run, not even a harness that is killed; the coordinator replays
its own program trace; a driver that comes as a new file runs through the
harness; the answers' JSON values are turned back into what the comparison
reads; the control fails the cell's comparison."""

import datetime
import json
import os
import shutil
import signal
import subprocess
import sys
import time

import pytest

from perfbench.control import readings
from perfbench.drivers._protocol import Coordinator
from perfbench.drivers.protocol import Driver, Process, wire_rows
from perfbench.harness import ForbiddenModules, run
from perfbench.traffic import Traffic

from .helpers import SEEDS, SF, mix, store, traffic

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ROOT = os.path.dirname(HERE)
CELL = "tpch-sf1-streams.protocol"


def stderr_lines(text: str, key: str) -> list:
    out = []
    for line in text.splitlines():
        if line.startswith("{"):
            d = json.loads(line)
            if key in d:
                out.append(d[key])
    return out


# faults planted in the driver's processes, the coordinator and the
# sessions: a ``sitecustomize`` module that each interpreter runs at
# start-up
FAULTS = {
    "altered_where_produced": """
import presto1_tpu_torch.server.coordinator as c
plain = c._json_value
def _json_value(v):
    v = plain(v)
    return v + 1 if type(v) in (int, float) else v
c._json_value = _json_value
""",
    "altered_wire_value": """
from presto1_tpu_torch.client.http_client import Client
plain = Client._request
def _request(self, method, path, body=None):
    out = plain(self, method, path, body)
    if out.get("data"):
        row = out["data"][0]
        v = row[-1]
        row[-1] = v + "x" if isinstance(v, str) else (
            1 if v is None else v + 1)
    return out
Client._request = _request
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
    "half_rows": """
from perfbench.port_catalog import BenchTable
plain_rows, plain_load = BenchTable.num_rows, BenchTable._load
def num_rows(self):
    return max(plain_rows.fget(self) // 2, 1)
def _load(self, name, device):
    c = plain_load(self, name, device)
    n = num_rows(self)
    return type(c)(c.data[:n], c.type,
                   validity=None if c.validity is None else c.validity[:n],
                   dictionary=c.dictionary)
BenchTable.num_rows = property(num_rows)
BenchTable._load = _load
""",
}
# what makes a process of the driver fail the look for forbidden modules:
# it loaded one, or it cannot say
UNCHECKED = {
    "jax_loaded": """
import sys, types
sys.modules["jax"] = types.ModuleType("jax")
""",
    "no_report": """
import perfbench.harness
def forbidden_modules():
    raise OSError("planted")
perfbench.harness.forbidden_modules = forbidden_modules
""",
}


def plant(monkeypatch, tmp_path, code: str) -> None:
    """``code`` runs at the start of every process the run starts."""
    (tmp_path / "sitecustomize.py").write_text(code)
    monkeypatch.setenv("PYTHONPATH", os.pathsep.join([str(tmp_path), ROOT]))


@pytest.mark.parametrize("fault", ["none", *FAULTS])
def test_protocol_cell(fault, monkeypatch, capsys, tmp_path):
    if fault != "none":
        plant(monkeypatch, tmp_path, FAULTS[fault])
    out = run(CELL, 2 ** 31 + 17, 2.0, False, device="cpu",
              config_override={"scale_factor": SF}, data_cache=None)
    assert out["correct"] is (fault == "none"), out["checks"]
    assert list(out)[-1] == "checks"
    # its tail is read per layer (query_p95_ms), not bounded end to end
    assert set(out["metrics"]) == {"queries_per_s", "geomean_ms",
                                   "setup_s"}
    sessions = stderr_lines(capsys.readouterr().err, "sessions")[-1]
    assert len(sessions["queries"]) == mix("protocol")["sessions"] == 2
    assert all(n > 0 for n in sessions["queries"]), sessions
    if fault == "none":
        assert sessions["right"] == sessions["queries"]


@pytest.mark.parametrize("fault", list(UNCHECKED))
def test_a_process_that_loads_jax_or_cannot_say_fails_the_run(
        fault, monkeypatch, tmp_path):
    plant(monkeypatch, tmp_path, UNCHECKED[fault])
    with pytest.raises(ForbiddenModules, match="jax" if fault == "jax_loaded"
                       else "no report"):
        run(CELL, 3, 1.0, False, device="cpu",
            config_override={"scale_factor": SF}, data_cache=None)


def test_close_fails_where_a_process_had_ended():
    """A process that exits before it is asked reports nothing: close
    raises, and ends the rest."""
    reply = ("import json, sys; sys.stdin.readline(); "
             "print(json.dumps({'forbidden': []}), flush=True)")
    procs = [subprocess.Popen([sys.executable, "-c", code], text=True,
                              stdin=subprocess.PIPE, stdout=subprocess.PIPE)
             for code in (reply, "pass", reply)]
    procs[1].wait()
    driver = Driver.__new__(Driver)
    driver.closed = False
    driver.sessions = [Process(f"session {k}", p)
                       for k, p in enumerate(procs[:2])]
    driver.coordinator = Process("coordinator", procs[2])
    with pytest.raises(ForbiddenModules, match="session 1"):
        driver.close()
    assert all(p.poll() is not None for p in procs)
    assert driver.close() == []


def test_the_coordinator_replays_its_own_program_trace():
    """The program-span metrics, read in the coordinator on its engine,
    each statement through ``execute_statement`` as the query manager
    sends it."""
    tr = traffic("tpch-sf1.scan", None)
    node = Coordinator("cpu", 0.0)
    try:
        node.setup({"name": "tpch-sf1-streams", "suite": "tpch",
                    "scale_factor": SF}, None, tr.columns(),
                   {"compile_queries": True})
        texts = [[i.name, i.text] for i in tr.instances]
        for _ in range(2):
            for _, text in texts:
                node.driver.engine.sql(text).to_pylist()
        m = node.program_trace(texts)["metrics"]
    finally:
        node.stop()
    assert set(m) == {"parse_plan_ms", "statement_self_ms",
                      "enqueue_ms_per_query", "host_syncs_per_query",
                      "host_wait_ms_per_query", "to_host_ms_per_query",
                      "unspanned_ms_per_query"}
    # execute_statement parses every text before Engine.sql, outside its
    # spans; Engine.sql finds each compiled (no parse span of its own)
    assert m["unspanned_ms_per_query"] > 0
    assert m["parse_plan_ms"] == 0
    assert m["host_syncs_per_query"] > 0


def _gone(pid: int) -> bool:
    """No process ``pid`` runs the driver's module (a zombie has ended)."""
    try:
        with open(f"/proc/{pid}/stat") as f:
            state = f.read().rsplit(")", 1)[1].split()[0]
        with open(f"/proc/{pid}/cmdline") as f:
            cmd = f.read()
    except FileNotFoundError:
        return True
    return state == "Z" or "_protocol.py" not in cmd


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
            if line.startswith('{"coordinator"') and pids is None:
                d = json.loads(line)
                pids = [d["coordinator"]["pid"], *d["session_pids"]]
            if line.startswith('{"setup"'):
                break
        assert pids is not None and len(pids) == 3
        assert not any(map(_gone, pids))
        if end == "killed":
            p.kill()
        p.stderr.read()
        assert p.wait(timeout=120) == (-signal.SIGKILL if end == "killed"
                                       else 0)
        deadline = time.monotonic() + 10
        while not all(map(_gone, pids)) and time.monotonic() < deadline:
            time.sleep(0.1)
        assert all(map(_gone, pids))
    finally:
        if p.poll() is None:
            p.kill()
            p.wait()


def test_a_driver_in_a_new_file_runs_through_the_harness(tmp_path):
    """A copy of the benchmark given three new files and a cell: the
    driver (``twin_driver.py``: one Engine a session), a mix of two
    sessions that names it, and nothing else changed."""
    shutil.copytree(HERE, tmp_path / "perfbench",
                    ignore=shutil.ignore_patterns(".cache", "__pycache__"))
    shutil.copy(os.path.join(HERE, "tests", "twin_driver.py"),
                tmp_path / "perfbench" / "drivers" / "twin.py")
    twin = dict(mix("scan"), driver="twin", sessions=2)
    (tmp_path / "perfbench" / "mixes" / "twin.json").write_text(
        json.dumps(twin))
    with open(os.path.join(ROOT, "BENCHMARK.json")) as f:
        bench = json.load(f)
    bench["workloads"].append({"name": "tpch-sf1.twin", "config": "tpch-sf1",
                               "traffic": "twin", "chips": 1, "why": "test"})
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(bench))
    code = (
        "import sys; sys.path[:0] = [%r, %r]\n"
        "import json, perfbench.harness as h\n"
        "assert h.__file__.startswith(%r), h.__file__\n"
        "out = h.run('tpch-sf1.twin', 9, 1.5, False, device='cpu',\n"
        "            config_override={'scale_factor': %r}, data_cache=None)\n"
        "print(json.dumps(out))\n"
        % (str(tmp_path), ROOT, str(tmp_path), SF))
    p = subprocess.run([sys.executable, "-c", code], capture_output=True,
                       text=True, timeout=600)
    assert p.returncode == 0, p.stderr[-3000:]
    out = json.loads(p.stdout.strip().splitlines()[-1])
    assert out["correct"], out["checks"]
    sessions = stderr_lines(p.stderr, "sessions")[-1]
    assert len(sessions["queries"]) == 2
    assert all(n > 0 for n in sessions["queries"]), sessions


def test_wire_values_turn_back_into_what_the_comparison_reads():
    columns = [{"name": "k", "type": "bigint"},
               {"name": "d", "type": "date"},
               {"name": "r", "type": "decimal(38,4)"}]
    rows = [[1, "1995-03-15", 0.5], [2, None, 1.25], [3, "1995-3-15x", 2.0]]
    assert wire_rows(columns, rows) == [
        [1, datetime.date(1995, 3, 15), 0.5], [2, None, 1.25],
        # not ISO text: kept as it came, so it compares unequal
        [3, "1995-3-15x", 2.0]]
    assert wire_rows(columns[:1], [[7]]) == [[7]]


@pytest.mark.parametrize("seed", (None,) + SEEDS)
def test_control_is_not_correct(seed):
    r = readings(Traffic(mix("protocol"), "tpch", seed or 0,
                         instance_seed=seed), store("tpch-sf1"))
    with open(os.path.join(HERE, "configs", "tpch-sf1-streams.json")) as f:
        lim = json.load(f)["limits"]
    assert r["wrong_answers"] > lim["wrong_answers"] \
        or r["double_rel_err"] > lim["double_rel_err"], r


def test_sessions_draw_orders_of_their_own():
    seed = 2 ** 31 + 5
    one = Traffic(mix("scan"), "tpch", seed)
    four = Traffic(mix("scan"), "tpch", seed)
    orders = []
    for k in range(4):
        seq = four.sequence(k)
        orders.append([next(seq).index for _ in range(40)])
    # session 0 draws the order a cell of one session has always drawn
    seq = one.sequence()
    assert orders[0] == [next(seq).index for _ in range(40)]
    assert len({tuple(o) for o in orders}) == 4
    assert all(sorted(o) == sorted(orders[0]) for o in orders)
