"""Seconds per phase of ``chip_smoke.py``, for several checkouts in turn.

    python3 presto1_tpu_torch/testing/smoke_phases.py --out DIR A B B A

runs ``chip_smoke.py`` of each checkout directory named, in the order
given, each from a cold start (its ``.tpch_cache`` and its kernel build
removed first, ``P1_TPCH_CACHE`` unset), and stamps every line of its
output with the seconds since its start.  A phase's seconds are the time
from the line before it to its own line.  Each run's stamped output goes
to ``DIR/run<i>-<name>.log``; one JSON line a run is printed (exit code,
total seconds, seconds by phase).  Name two checkouts in the order parent,
change, change, parent to compare them on one card in one call.
"""

from __future__ import annotations

import argparse
import json
import os
import shutil
import subprocess
import sys
import threading
import time

RUN_TIMEOUT_S = 1200  # the script's own limit: a run is killed after it


def run_one(checkout: str, log_path: str) -> dict:
    """One cold run of ``checkout``'s ``chip_smoke.py``: exit code, total
    seconds and seconds by phase (summed where a phase prints twice)."""
    for sub in (".tpch_cache", "presto1_tpu_torch/ops/kernels/build"):
        shutil.rmtree(os.path.join(checkout, sub), ignore_errors=True)
    env = {k: v for k, v in os.environ.items() if k != "P1_TPCH_CACHE"}
    phases: dict = {}
    t0 = time.time()
    last = 0.0
    proc = subprocess.Popen([sys.executable, "-u", "chip_smoke.py"],
                            cwd=checkout, env=env, stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True)
    timer = threading.Timer(RUN_TIMEOUT_S, proc.kill)
    timer.start()
    try:
        with open(log_path, "w") as log:
            for line in proc.stdout:
                t = time.time() - t0
                log.write(f"{t:9.2f} {line}")
                try:
                    obj = json.loads(line)
                except ValueError:
                    continue
                phase = obj.get("phase") if isinstance(obj, dict) else None
                if phase is not None:
                    phases[phase] = phases.get(phase, 0.0) + t - last
                    last = t
        rc = proc.wait()
    finally:
        timer.cancel()
        if proc.poll() is None:
            proc.kill()
            proc.wait()
    return {"rc": rc, "seconds": time.time() - t0, "phases": phases}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("checkouts", nargs="+",
                    help="checkout directories, run in this order")
    ap.add_argument("--out", required=True, help="directory for the logs")
    args = ap.parse_args(argv)
    os.makedirs(args.out, exist_ok=True)
    failed = False
    for i, checkout in enumerate(args.checkouts, 1):
        name = os.path.basename(os.path.abspath(checkout))
        res = run_one(checkout, os.path.join(args.out, f"run{i}-{name}.log"))
        failed |= res["rc"] != 0
        print(json.dumps({"run": i, "checkout": name, **res}), flush=True)
    return 1 if failed else 0


if __name__ == "__main__":
    sys.exit(main())
