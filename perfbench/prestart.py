"""What a cell's driver starts before the harness's own process imports
torch, so that the two processes import at the same time.

A driver ``<name>`` whose program runs in a process of its own may come with
that process's module, ``perfbench/drivers/_<name>.py``, which imports
nothing heavy when it is imported and whose ``start(device)`` returns the
process (a ``subprocess.Popen``).  ``perfbench/run.py`` calls ``prestart``
first; the driver takes the process over from ``Setting.started``.  Only the
standard library is imported here.
"""

from __future__ import annotations

import argparse
import importlib
import json
import os
from importlib.util import find_spec
from typing import List, Optional

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# the device a run of ``perfbench/run.py`` uses
DEVICE = "cuda:0"


def prestart(argv: List[str]):
    """The process the workload's driver starts, or None where it starts
    none (or the arguments name no workload the benchmark has: the harness
    reports that)."""
    ap = argparse.ArgumentParser(add_help=False)
    ap.add_argument("--workload")
    workload = ap.parse_known_args(argv)[0].workload
    try:
        with open(os.path.join(ROOT, "BENCHMARK.json")) as f:
            bench = json.load(f)
        cell = next(w for w in bench["workloads"] if w["name"] == workload)
        with open(os.path.join(ROOT, "perfbench", "mixes",
                               cell["traffic"] + ".json")) as f:
            name: Optional[str] = json.load(f).get("driver")
    except (OSError, ValueError, KeyError, StopIteration):
        return None
    if name is None or find_spec(f"perfbench.drivers._{name}") is None:
        return None
    return importlib.import_module(f"perfbench.drivers._{name}").start(DEVICE)
