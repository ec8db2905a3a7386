"""One run of one cell: set-up, a closed-loop window of queries through
``Engine.sql`` and ``RecordBatch.to_pylist``, then the comparison of every
answer with the plain reference.

Everything that belongs to a cell is found by name: the cell in
``BENCHMARK.json``, its configuration in ``perfbench/configs/<config>.json``,
its mix in ``perfbench/mixes/<traffic>.json``, the mix's templates in
``perfbench/reference/<suite>_<template>.py`` and each per-layer metric's
reader in ``perfbench/metrics/<metric>.py``.
"""

from __future__ import annotations

import gc
import importlib
import json
import math
import os
import statistics
import subprocess
import sys
import time
from typing import Dict, List, Optional

import numpy as np
import torch

from .data.store import CACHE, Store
from .traffic import Traffic

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
# modules that must not be loaded in a run: JAX and the JAX package (whole
# top-level names: the port's own name begins with the JAX package's)
FORBIDDEN = ("jax", "jaxlib", "flax", "presto1_tpu")
# spin kernels a trace starts with: the profiler has dropped the first
# device events of a session, and these absorb them (left out of every sum)
PROFILE_LEAD = 32


def log(**kv) -> None:
    print(json.dumps(kv, default=str), file=sys.stderr, flush=True)


def load_json(path: str) -> dict:
    with open(path) as f:
        return json.load(f)


def cell_of(bench: dict, workload: str) -> dict:
    for w in bench["workloads"]:
        if w["name"] == workload:
            return w
    raise SystemExit(f"no workload {workload!r} in BENCHMARK.json")


def metrics_of(bench: dict, cell: dict, kind: str) -> List[dict]:
    """The cell's end-to-end (``kind`` = "end_to_end") or per-layer
    metrics: a metric with ``workloads`` applies to those cells; one
    without applies to every cell that reports the metric it moves."""
    e2e = {m["name"] for m in bench["end_to_end"]
           if cell["name"] in m.get("workloads", [cell["name"]])}
    if kind == "end_to_end":
        return [m for m in bench["end_to_end"] if m["name"] in e2e]
    return [m for m in bench["per_layer"]
            if (cell["name"] in m["workloads"] if "workloads" in m
                else m["moves"] in e2e)]


def card(device: torch.device) -> Optional[str]:
    """``name, power limit`` of the card, as nvidia-smi prints them."""
    if device.type != "cuda":
        return None
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader", f"--id={device.index or 0}"],
            capture_output=True, text=True, timeout=30)
    except (OSError, subprocess.TimeoutExpired) as e:
        return f"nvidia-smi failed: {e}"
    return out.stdout.strip()


def copy_rate(device: torch.device, nbytes: int = 1 << 30) -> float:
    """GB/s of a device-to-device ``copy_`` (read and write counted): the
    median of five CUDA-event timings of ten copies."""
    src = torch.empty(nbytes, dtype=torch.uint8, device=device)
    dst = torch.empty_like(src)
    dst.copy_(src)
    out = []
    for _ in range(5):
        e0 = torch.cuda.Event(enable_timing=True)
        e1 = torch.cuda.Event(enable_timing=True)
        e0.record()
        for _ in range(10):
            dst.copy_(src)
        e1.record()
        e1.synchronize()
        out.append(e0.elapsed_time(e1) / 1e3 / 10)
    return 2 * nbytes / statistics.median(out) / 1e9


def busy_intervals(intervals) -> List[tuple]:
    """The union of ``(start, end)`` intervals as disjoint sorted ones
    (the arithmetic of ``presto1_tpu_torch/testing/roofline.py``'s
    ``busy_time``)."""
    out: List[list] = []
    for lo, hi in sorted(intervals):
        if out and lo <= out[-1][1]:
            out[-1][1] = max(out[-1][1], hi)
        else:
            out.append([lo, hi])
    return [tuple(iv) for iv in out]


class Trace:
    """What the profiler saw of the device over the traced queries: busy
    time (the union of device intervals), kernels, the device operations
    that took most time and the longest idle gaps, each named by the
    benchmark's host span that was open.

    The profiler traces the device alone, so the host runs the traced
    queries at close to its untraced speed; the window's wall and the spans
    are the host's clock (``spans``: ``(start_ns, end_ns, name)`` of
    ``time.perf_counter``).  The lead spin kernels set the host's clock
    onto the trace's: the last of them ends just before the synchronize
    that returned at ``sync_ns``."""

    def __init__(self, prof, queries: int, spans: List[tuple],
                 sync_ns: int):
        cuda = torch.autograd.DeviceType.CUDA
        device, spin_end = [], None
        for ev in prof.events():
            if ev.device_type != cuda or getattr(ev, "is_user_annotation",
                                                 False):
                continue
            if "spin_kernel" in ev.name:
                spin_end = max(spin_end or 0.0, ev.time_range.end)
            else:
                device.append(ev)
        busy = busy_intervals([(ev.time_range.start, ev.time_range.end)
                               for ev in device])
        self.queries = queries
        self.window_s = (spans[-1][1] - spans[0][0]) / 1e9
        self.busy_s = sum(b - a for a, b in busy) / 1e6
        self.kernels = sum(1 for ev in device
                           if not ev.name.startswith(("Memcpy", "Memset")))
        self.device_events = len(device)
        by_name: Dict[str, float] = {}
        for ev in device:
            by_name[ev.name] = by_name.get(ev.name, 0.0) + (
                ev.time_range.end - ev.time_range.start) / 1e6
        self.device_ops = sorted(by_name.items(), key=lambda kv: -kv[1])[:10]
        # the trace's microseconds on the host's clock: host_ns = us * 1e3
        # + offset; without the spin kernels the gaps go unnamed
        offset = None if spin_end is None else sync_ns - spin_end * 1e3
        self.aligned = offset is not None
        if busy and offset is not None:
            lo = min(busy[0][0], (spans[0][0] - offset) / 1e3)
            hi = max(busy[-1][1], (spans[-1][1] - offset) / 1e3)
        elif busy:
            lo, hi = busy[0][0], busy[-1][1]
        else:
            lo = hi = 0.0
        gaps = [(a, b) for a, b in zip([lo] + [e for _, e in busy],
                                       [s for s, _ in busy] + [hi]) if b > a]
        gaps.sort(key=lambda g: g[0] - g[1])
        self.idle_gaps = [
            (self._label(spans, (a + b) / 2 * 1e3 + offset)
             if offset is not None else "unaligned", (b - a) / 1e6)
            for a, b in gaps[:10]]
        # first kernel after the first query's start: the alignment's check
        self.lead_ms = None if offset is None or not busy else \
            (busy[0][0] * 1e3 + offset - spans[0][0]) / 1e6

    @staticmethod
    def _label(spans, t) -> str:
        inner = [s for s in spans if s[0] <= t <= s[1]]
        return min(inner, key=lambda s: s[1] - s[0])[2] if inner else "loop"


class Run:
    """What a per-layer metric's reader may read: the trace, the queries
    it covered, the engine (still alive), the window's texts, the column
    store, the device's name and the table of peaks."""

    def __init__(self, **kv):
        self.__dict__.update(kv)


def run(workload: str, seed: int, seconds: float, trace: bool,
        device: str = "cuda", t_start: float = None,
        config_override: Optional[dict] = None,
        data_cache: Optional[str] = CACHE) -> dict:
    """One run of ``workload``; returns the result line's object.  The
    caller checks for the card first.  ``config_override`` and
    ``data_cache`` let a test run a cell at a small scale factor."""
    t_start = time.perf_counter() if t_start is None else t_start
    from presto1_tpu_torch.exec.engine import Engine
    from presto1_tpu_torch.exec.session import Session

    from .port_catalog import BenchCatalog

    t_import = time.perf_counter()
    bench = load_json(os.path.join(ROOT, "BENCHMARK.json"))
    cell = cell_of(bench, workload)
    entry = next(c for c in bench["configs"] if c["name"] == cell["config"])
    config = load_json(os.path.join(ROOT, entry["file"]))
    config.update(config_override or {})
    config["name"] = cell["config"]
    mix = load_json(os.path.join(HERE, "mixes", cell["traffic"] + ".json"))
    dev = torch.device(device)

    store = Store(config, cache=data_cache)
    traffic = Traffic(mix, config["suite"], seed)
    columns = traffic.columns()
    tables = {t: {c: store.column(t, c) for c in cols}
              for t, cols in columns.items()}
    t_data = time.perf_counter()

    catalog = BenchCatalog(store, device=dev)
    for t, cols in columns.items():
        for c in cols:
            catalog.table(t).column(c)
    sync(dev)
    t_upload = time.perf_counter()

    session = Session()
    for k, v in mix["session"].items():
        session.set(k, v)
    engine = Engine(catalog, session=session, device=dev)
    for inst in traffic.instances:
        engine.sql(inst.text).to_pylist()
    t_compile = time.perf_counter()
    for inst in traffic.instances:
        engine.sql(inst.text).to_pylist()
    sync(dev)
    t_warm = time.perf_counter()
    setup = {"import_s": t_import - t_start, "data_s": t_data - t_import,
             "columns_generated": store.generated,
             "upload_s": t_upload - t_data, "compile_s": t_compile - t_upload,
             "warm_s": t_warm - t_compile, "texts": len(traffic.instances),
             "setup_s": t_warm - t_start}
    log(setup=setup)
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats(dev)

    records, answers, traced = window(engine, traffic, seconds, trace, mix,
                                      dev)
    peak = int(torch.cuda.max_memory_allocated(dev)) \
        if dev.type == "cuda" else 0

    kind = torch.cuda.get_device_name(dev) if dev.type == "cuda" else \
        dev.type
    device_out = {"platform": "gpu" if dev.type == "cuda" else dev.type,
                  "kind": kind, "count": 1, "memory_peak_bytes": peak}
    layer: Dict[str, dict] = {}
    breakdown = None
    if traced:
        tr = traced["trace"]
        device_out.update(busy_s=tr.busy_s, window_s=tr.window_s)
        breakdown = {"device_ops": [list(x) for x in tr.device_ops],
                     "idle_gaps": [list(x) for x in tr.idle_gaps]}
        ctx = Run(trace=tr, traced=traced["instances"], engine=engine,
                  texts=sorted({r[0].text for r in records}),
                  store=store, device_kind=kind,
                  peaks=load_json(os.path.join(HERE, "peaks.json")))
        for m in metrics_of(bench, cell, "per_layer"):
            value = importlib.import_module(
                f"{__package__}.metrics.{m['name']}").read(ctx)
            if value is not None:
                layer[m["name"]] = {"value": value, "unit": m["unit"]}
        # what tracing costs the host: each template's mean latency traced
        # over its mean in the untraced rest of the window
        n = tr.queries
        slow = {}
        for name in traffic.templates:
            a = [r[1] for r in records[:n] if r[0].name == name]
            b = [r[1] for r in records[n:] if r[0].name == name]
            if a and b:
                slow[name] = statistics.fmean(a) / statistics.fmean(b)
        log(trace={"queries": tr.queries, "kernels": tr.kernels,
                   "device_events": tr.device_events, "busy_s": tr.busy_s,
                   "window_s": tr.window_s, "aligned": tr.aligned,
                   "first_kernel_after_ms": tr.lead_ms,
                   "traced_over_untraced_latency": slow})
        if dev.type == "cuda":
            log(copy_rate_gb_s=copy_rate(dev))
    log(card=card(dev))

    # the program's state goes before the reference runs
    del engine, catalog
    gc.collect()
    if dev.type == "cuda":
        torch.cuda.empty_cache()

    limits = config["limits"]
    t_ref = time.perf_counter()
    verdict = check(answers, traffic, tables)
    log(reference_s=time.perf_counter() - t_ref,
        checked_answers=verdict["checked_answers"],
        distinct_answers=sum(map(len, answers.distinct.values())))
    by_template: Dict[str, list] = {}
    for inst, lat, _, _ in records:
        by_template.setdefault(inst.name, []).append(lat * 1e3)
    log(latency_ms={n: {"queries": len(v), "median": statistics.median(v),
                        "p95": float(np.percentile(v, 95)), "max": max(v)}
                    for n, v in by_template.items()})
    attempted = len(records)
    failed = sum(1 for r in records if r[2] is None)
    checks = {
        "failed": {"value": failed, "limit": 0},
        "wrong_answers": {"value": verdict["wrong"],
                          "limit": limits["wrong_answers"]},
    }
    if any("double" in m.OUTPUT for m in traffic.templates.values()):
        # only where an answer holds a double is there an error to read
        checks["double_rel_err"] = {"value": verdict["worst"],
                                    "limit": limits["double_rel_err"]}
    correct = all(c["value"] <= c["limit"] for c in checks.values())
    out = {"correct": correct, "attempted": attempted, "failed": failed}
    if trace:
        out["metrics"] = layer
    else:
        lat = [r[1] for r in records]
        good = sum(1 for r in records if r[2] in verdict["right"])
        span = records[-1][3] - records[0][3] + records[0][1] \
            if records else math.nan
        values = {
            "queries_per_s": good / span,
            "geomean_ms": math.exp(statistics.fmean(
                math.log(x * 1e3) for x in lat)),
            "latency_p95_ms": float(np.percentile(lat, 95)) * 1e3,
            "setup_s": setup["setup_s"],
        }
        out["metrics"] = {m["name"]: {"value": values[m["name"]],
                                      "unit": m["unit"]}
                          for m in metrics_of(bench, cell, "end_to_end")}
    out["device"] = device_out
    if breakdown is not None:
        out["breakdown"] = breakdown
    out["checks"] = checks
    return out


def sync(dev: torch.device) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def window(engine, traffic: Traffic, seconds: float, trace: bool, mix: dict,
           dev: torch.device):
    """The closed loop: each query is sent when the last answer is in the
    host's list.  Records (instance, latency s, the answer's key in
    ``answers`` or None if the query raised, end time).  A traced run
    profiles the device over its first ``trace_queries`` queries, keeping
    host spans around ``Engine.sql`` and ``to_pylist``, and goes on
    untraced to the window's end."""
    from torch.profiler import ProfilerActivity, profile

    seq = traffic.sequence()
    records = []
    answers = Answers()
    traced = {}

    def one(inst, spans=None):
        t0 = time.perf_counter()
        try:
            if spans is None:
                rows = engine.sql(inst.text).to_pylist()
            else:
                out = engine.sql(inst.text)
                t_sql = time.perf_counter()
                rows = out.to_pylist()
        except Exception as e:  # a query that fails counts as failed
            log(query_failed=inst.name, params=inst.params, error=repr(e))
            rows = None
        t1 = time.perf_counter()
        records.append((inst, t1 - t0, answers.add(inst.index, rows), t1))
        if spans is not None:
            t_sql = t1 if rows is None else t_sql
            spans += [(round(t0 * 1e9), round(t_sql * 1e9),
                       f"sql:{inst.name}"),
                      (round(t_sql * 1e9), round(t1 * 1e9),
                       f"to_host:{inst.name}")]

    t_end = time.perf_counter() + seconds
    if trace and dev.type == "cuda":
        n = mix["trace_queries"]
        spans: List[tuple] = []
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(PROFILE_LEAD):
                torch.cuda._sleep(1)
            torch.cuda.synchronize(dev)
            sync_ns = round(time.perf_counter() * 1e9)
            insts = [next(seq) for _ in range(n)]
            for inst in insts:
                one(inst, spans)
        traced = {"trace": Trace(prof, n, spans, sync_ns),
                  "instances": insts}
    while time.perf_counter() < t_end:
        one(next(seq))
    return records, answers, traced


class Answers:
    """Each instance's distinct answers, with how often each came: an
    answer equal to one already kept is counted, not kept again, so the
    window does not fill the process with objects for the collector to
    walk."""

    # distinct answers an instance's new answer is held against; beyond
    # them answers are kept as they come
    MATCH = 8

    def __init__(self):
        self.distinct: Dict[int, List[list]] = {}

    def add(self, index: int, rows) -> Optional[tuple]:
        if rows is None:
            return None
        kept = self.distinct.setdefault(index, [])
        for k, entry in enumerate(kept[:self.MATCH]):
            if entry[0] == rows:
                entry[1] += 1
                return index, k
        kept.append([rows, 1])
        return index, len(kept) - 1


def check(answers: Answers, traffic: Traffic, tables) -> dict:
    """Every answer of every instance against the reference, once the
    window has closed: the count of wrong answers (a row, an exact value
    or the order differs), the largest relative error of a double, and
    the keys of the answers that were right."""
    from .reference.common import judge, normal

    wrong, worst, right, n = 0, 0.0, set(), 0
    for name, module in traffic.templates.items():
        insts = [i for i in traffic.by_template[name]
                 if i.index in answers.distinct]
        if not insts:
            continue
        ctx = module.prepare({t: tables[t] for t in module.COLUMNS})
        for inst in insts:
            want = module.answer(ctx, inst.params)
            for k, (rows, count) in enumerate(answers.distinct[inst.index]):
                n += count
                ok, err = judge(rows, want, module.OUTPUT, module.ORDER_KEY,
                                module.LIMIT)
                worst = max(worst, err)
                if ok:
                    right.add((inst.index, k))
                else:
                    if wrong < 3:
                        log(wrong_answer=name, params=inst.params,
                            got=[[normal(v) for v in r] for r in rows[:3]],
                            rows=len(rows), want=want[:3],
                            want_rows=len(want))
                    wrong += count
        del ctx
    return {"wrong": wrong, "worst": worst, "right": right,
            "checked_answers": n}


def forbidden_modules() -> List[str]:
    return sorted({m.split(".")[0] for m in sys.modules} & set(FORBIDDEN))


def main(argv=None, t_start: float = None) -> int:
    import argparse

    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    bench = load_json(os.path.join(ROOT, "BENCHMARK.json"))
    chips = cell_of(bench, args.workload)["chips"]
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"perfbench: the cell needs {chips} CUDA device(s); "
              f"torch.cuda.is_available() is {torch.cuda.is_available()}, "
              f"device_count() {torch.cuda.device_count()}", file=sys.stderr)
        return 2
    out = run(args.workload, args.seed, args.seconds, bool(args.trace),
              device="cuda:0", t_start=t_start)
    found = forbidden_modules()
    if found:
        print(f"perfbench: loaded in this process: {found}", file=sys.stderr)
        return 3
    for name, c in out["checks"].items():
        print(f"check {name}: {c['value']!r} (limit {c['limit']!r})",
              file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(out, allow_nan=False), flush=True)
    return 0
