"""``presto1_tpu_torch/testing/smoke_phases.py`` on stand-in checkouts: the
seconds it gives a phase are the time from the line before to the phase's
own line, a run starts cold, and a failing run makes it exit non-zero."""

import json
import os
import subprocess
import sys

from presto1_tpu_torch.testing import smoke_phases

_SMOKE = """import json, os, time
print("build " + str(os.path.exists(".tpch_cache")))
print(json.dumps({"phase": "a"}))
time.sleep(0.3)
print(json.dumps({"phase": "b"}))
print(json.dumps({"phase": "a"}))
print(json.dumps({"ok": True}))
"""


def _checkout(root, name, body):
    d = root / name
    (d / ".tpch_cache").mkdir(parents=True)
    (d / "chip_smoke.py").write_text(body)
    return d


def test_phases_are_timed_from_the_line_before(tmp_path):
    d = _checkout(tmp_path, "change", _SMOKE)
    res = smoke_phases.run_one(str(d), str(tmp_path / "run.log"))
    assert res["rc"] == 0
    assert sorted(res["phases"]) == ["a", "b"]
    assert 0.25 < res["phases"]["b"] < 5
    assert res["phases"]["a"] < 0.25
    assert res["seconds"] >= res["phases"]["a"] + res["phases"]["b"]
    log = (tmp_path / "run.log").read_text().splitlines()
    # the cache was removed before the run; every line is stamped
    assert log[0].split() == [log[0].split()[0], "build", "False"]
    assert [float(x.split()[0]) for x in log] == sorted(
        float(x.split()[0]) for x in log)


def test_a_failing_run_fails_the_comparison(tmp_path):
    good = _checkout(tmp_path, "parent", _SMOKE)
    bad = _checkout(tmp_path, "broken", "import sys\nsys.exit(3)\n")
    out = tmp_path / "logs"
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    p = subprocess.run(
        [sys.executable, os.path.join(repo, "presto1_tpu_torch", "testing",
                                      "smoke_phases.py"),
         "--out", str(out), str(good), str(bad)],
        capture_output=True, text=True, timeout=120)
    assert p.returncode == 1
    runs = [json.loads(x) for x in p.stdout.splitlines()]
    assert [(r["run"], r["checkout"], r["rc"]) for r in runs] == [
        (1, "parent", 0), (2, "broken", 3)]
    assert sorted(os.listdir(out)) == ["run1-parent.log", "run2-broken.log"]
