"""The program's own trace of the traced queries, shared by the readers of
the program-span and program-counter metrics.

After the window, the instances the device trace covered are sent again
three times with the engine's tracing switched on (``Engine.trace``; each
statement's ``QueryTrace`` comes with its completed event,
``presto1_tpu_torch/trace.py``):

1. paired with untraced calls, the order alternating, for what tracing
   costs each template;
2. under a CUDA-only profile that opens with the harness's lead spin kernels
   (``harness.PROFILE_LEAD``): the metrics read this replay, its device
   idle time is put down to the innermost program span open, and each
   call's hand-kernel launches are counted by family
   (``ops/kernels.launch_counts``);
3. under ``torch.cuda.set_sync_debug_mode("warn")``, counting the
   synchronizing calls torch reports beside the trace's ``wait`` spans.

A span's self time is its duration less its child spans'.  Every metric is
a mean over the statements of replay 2; ``unspanned_ms_per_query`` is a
call's host time in no root span (``statement``, ``to_host``).  A program
that keeps no trace gives None: no metric of this family is read.  One line
``{"program_trace": ...}`` on standard error holds the rest, by template.
"""

from __future__ import annotations

import collections
import os
import statistics
import time
import warnings
from typing import Dict, List, Optional

import torch

from presto1_tpu_torch.ops.kernels import launch_counts

from .. import harness

# span names whose self time is the executor's enqueue (and every op:*)
ENQUEUE = ("run", "fragment", "execute")
FRONTEND = ("parse", "plan", "optimize")


def of(run) -> Optional[dict]:
    """The metrics' values, computed once per run (kept on ``run``)."""
    if "_program_trace" not in run.__dict__:
        run._program_trace = _measure(run)
    return run._program_trace


def _measure(run) -> Optional[dict]:
    engine = run.engine
    if not hasattr(engine, "trace") or not run.traced:
        return None
    traces: List = []
    collecting = [False]

    def listen(event) -> None:
        if collecting[0] and event.kind == "completed":
            traces.append(event.trace)

    engine.events.register(listen)
    insts = run.traced
    try:
        cost = _paired(engine, insts)
        engine.trace = True
        collecting[0] = True
        replay = _replay(engine, insts, engine.device)
        kept = list(traces)
        syncs = _sync_counts(engine, insts, traces) \
            if engine.device.type == "cuda" else None
    finally:
        engine.trace = False
        collecting[0] = False
    names = [outer[2] for outer in replay["outer"]]
    if not kept or len(kept) != len(names):
        return None
    per = [dict(_statement(t), launches=n)
           for t, n in zip(kept, replay["launches"])]
    metrics = {k: statistics.fmean(p["metrics"][k] for p in per)
               for k in per[0]["metrics"]}
    detail = {"queries": len(insts), "metrics": metrics,
              "templates": _by_template(names, per),
              "tracing_cost": cost}
    detail.update(_coverage(replay, kept))
    if replay["prof"] is not None:
        detail.update(_idle(replay, kept, names))
    if syncs is not None:
        detail["sync_check"] = syncs
    harness.log(program_trace=detail)
    return dict(metrics,
                unspanned_ms_per_query=detail["outside_ms_per_query"])


def _one(engine, inst):
    """``engine.sql(text).to_pylist()`` as the harness sends it: host ns
    at its start and end, or None if the statement raised."""
    t0 = time.perf_counter_ns()
    try:
        engine.sql(inst.text).to_pylist()
    except Exception as e:  # counted by the window already; skipped here
        harness.log(program_trace_query_failed=inst.name, error=repr(e))
        return None
    return t0, time.perf_counter_ns()


def _paired(engine, insts) -> Dict[str, dict]:
    """Each template's median latency (ms) untraced and traced, each
    instance sent once each way, alternating which goes first."""
    lat: Dict[bool, Dict[str, list]] = {False: {}, True: {}}
    for k, inst in enumerate(insts):
        for on in ((False, True) if k % 2 == 0 else (True, False)):
            engine.trace = on
            t = _one(engine, inst)
            if t is not None:
                lat[on].setdefault(inst.name, []).append((t[1] - t[0]) / 1e6)
    out = {}
    for name in lat[False]:
        off = statistics.median(lat[False][name])
        on = statistics.median(lat[True].get(name, [float("nan")]))
        out[name] = {"untraced_ms": off, "traced_ms": on,
                     "traced_over_untraced": on / off}
    return out


def _replay(engine, insts, device) -> dict:
    """The traced replay: host spans ``(start_ns, end_ns, template)`` of
    each call and its launches by family (read between calls), under a
    CUDA-only profile on a CUDA device."""
    outer, launches = [], []
    prof = sync_ns = None

    def calls():
        for inst in insts:
            before = launch_counts()
            t = _one(engine, inst)
            if t is not None:
                after = launch_counts()
                outer.append((*t, inst.name))
                launches.append({k: after[k] - before[k] for k in after})

    if device.type == "cuda":
        from torch.profiler import ProfilerActivity, profile

        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(harness.PROFILE_LEAD):
                torch.cuda._sleep(1)
            torch.cuda.synchronize(device)
            sync_ns = time.perf_counter_ns()
            calls()
    else:
        calls()
    return {"outer": outer, "launches": launches, "prof": prof,
            "sync_ns": sync_ns}


def _statement(trace) -> dict:
    """One statement's metrics, and its self ms and spans by span name."""
    own = trace.self_ns()
    ms = {k: v / 1e6 for k, v in own.items()}
    spans = collections.Counter(s[0] for s in trace.spans)
    waited = sum(s[2] - s[1] for s in trace.spans if s[0] == "wait") / 1e6
    enqueue = sum(v for k, v in ms.items()
                  if k in ENQUEUE or k.startswith("op:"))
    metrics = {
        "parse_plan_ms": sum(ms.get(k, 0.0) for k in FRONTEND),
        "statement_self_ms": ms.get("statement", 0.0),
        "enqueue_ms_per_query": enqueue,
        "host_syncs_per_query": spans["wait"],
        "host_wait_ms_per_query": waited,
        "to_host_ms_per_query": ms.get("to_host", 0.0),
    }
    return {"metrics": metrics, "self_ms": ms, "spans": dict(spans)}


def _mean_dicts(dicts) -> dict:
    keys = sorted({k for d in dicts for k in d})
    return {k: sum(d.get(k, 0) for d in dicts) / len(dicts) for k in keys}


def _by_template(names, per) -> dict:
    out = {}
    for name in sorted(set(names)):
        mine = [p for n, p in zip(names, per) if n == name]
        out[name] = {"queries": len(mine),
                     "self_ms": _mean_dicts([p["self_ms"] for p in mine]),
                     "spans": _mean_dicts([p["spans"] for p in mine]),
                     "launches": _mean_dicts([p["launches"] for p in mine])}
    return out


def _coverage(replay, traces) -> dict:
    """The calls' mean host latency, the share of it that the
    ``statement`` and ``to_host`` spans cover, and the mean rest."""
    calls = [b - a for a, b, _ in replay["outer"]]
    wall = sum(calls)
    roots = sum(s[2] - s[1] for t in traces for s in t.spans
                if s[3] is None)
    return {"latency_ms_per_query": wall / len(calls) / 1e6,
            "root_spans_over_latency": roots / wall,
            "outside_ms_per_query": (wall - roots) / len(calls) / 1e6}


def pieces(spans) -> list:
    """``(lo, hi, name)``: the stretches of the timeline where ``name`` is
    the innermost of ``spans`` (``(start, end, name)``, each pair nested or
    disjoint) that is open; stretches where none is open are left out."""
    out, stack, t = [], [], None
    for lo, hi, name in sorted(spans, key=lambda s: (s[0], -s[1])):
        while stack and stack[-1][0] <= lo:
            end, inner = stack.pop()
            if t < end:
                out.append((t, end, inner))
                t = end
        if stack and t < lo:
            out.append((t, lo, stack[-1][1]))
        t = lo
        stack.append((hi, name))
    while stack:
        end, inner = stack.pop()
        if t < end:
            out.append((t, end, inner))
            t = end
    return out


def overlap_by_name(intervals, labelled) -> Dict[str, float]:
    """The length of ``intervals`` (sorted, disjoint) inside each name's
    stretches of ``labelled`` (``(lo, hi, name)``, sorted, disjoint)."""
    out: Dict[str, float] = collections.defaultdict(float)
    j = 0
    for lo, hi in intervals:
        while j < len(labelled) and labelled[j][1] <= lo:
            j += 1
        k = j
        while k < len(labelled) and labelled[k][0] < hi:
            a, b, name = labelled[k]
            cut = min(b, hi) - max(a, lo)
            if cut > 0:
                out[name] += cut
            k += 1
    return dict(out)


def device_busy_ns(prof, sync_ns) -> Optional[list]:
    """The device's busy intervals on the host's clock (ns): the union of
    the trace's device events without the spin kernels, set onto the host
    clock by them as ``harness.Trace`` does; None without the spins."""
    cuda = torch.autograd.DeviceType.CUDA
    device, spin_end = [], None
    for ev in prof.events():
        if ev.device_type != cuda or getattr(ev, "is_user_annotation",
                                             False):
            continue
        if "spin_kernel" in ev.name:
            spin_end = max(spin_end or 0.0, ev.time_range.end)
        else:
            device.append((ev.time_range.start, ev.time_range.end))
    if spin_end is None:
        return None
    offset = sync_ns - spin_end * 1e3
    return [(a * 1e3 + offset, b * 1e3 + offset)
            for a, b in harness.busy_intervals(device)]


def idle_intervals(busy, lo, hi) -> list:
    """The stretches of ``[lo, hi]`` outside the sorted, disjoint ``busy``."""
    out, t = [], lo
    for a, b in busy:
        if b <= t:
            continue
        if a >= hi:
            break
        if a > t:
            out.append((t, a))
        t = max(t, b)
    if t < hi:
        out.append((t, hi))
    return out


def _idle(replay, traces, names) -> dict:
    """The replay's device-idle ms by template and innermost program span
    (``outside``: inside a call, in no span), between calls, and the
    longest idle gaps as ``harness.Trace`` names them from the program's
    spans."""
    outer, prof, sync_ns = replay["outer"], replay["prof"], replay["sync_ns"]
    labelled = [(s[1], s[2], f"{name}:{s[0]}")
                for t, name in zip(traces, names) for s in t.spans]
    calls = [(a, b, f"{name}:outside") for a, b, name in outer]
    # the harness's reduction, with the program's spans for names; it reads
    # the window from the first span's start and the last one's end
    trace = harness.Trace(prof, len(outer), [calls[0], *labelled, *calls],
                          sync_ns)
    out = {"aligned": trace.aligned, "gaps": trace.idle_gaps,
           "busy_ms": trace.busy_s * 1e3, "window_ms": trace.window_s * 1e3}
    busy = device_busy_ns(prof, sync_ns)
    if busy is None:
        return out
    idle = idle_intervals(busy, outer[0][0], outer[-1][1])
    total = sum(b - a for a, b in idle)
    # program spans lie inside their call: a call's idle in none of them is
    # its "outside"
    in_spans: Dict[str, Dict[str, float]] = {}
    for key, ns in overlap_by_name(idle, pieces(labelled)).items():
        name, span_name = key.split(":", 1)
        in_spans.setdefault(name, {})[span_name] = ns
    in_calls = {k.split(":", 1)[0]: ns
                for k, ns in overlap_by_name(idle, sorted(calls)).items()}
    by_template = {}
    for name, ns in in_calls.items():
        mine = in_spans.get(name, {})
        by_template[name] = {k: v / 1e6 for k, v in sorted(mine.items())}
        by_template[name]["outside"] = (ns - sum(mine.values())) / 1e6
    spanned = sum(sum(m.values()) for m in in_spans.values())
    out.update(idle_ms=by_template,
               idle_between_calls_ms=(total - sum(in_calls.values())) / 1e6,
               idle_total_ms=total / 1e6,
               idle_in_program_spans_share=spanned / total if total else None)
    return out


def _sync_counts(engine, insts, traces) -> dict:
    """Per template, the synchronizing calls torch reports in a replay
    under ``set_sync_debug_mode("warn")`` against the trace's ``wait``
    spans over the same calls, per query, and the lines torch reported
    most."""
    counts: Dict[str, list] = {}
    sites: collections.Counter = collections.Counter()
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            for inst in insts:
                before = len(caught)
                if _one(engine, inst) is None:
                    continue
                found = [w for w in caught[before:]
                         if "synchronizing" in str(w.message)]
                # the listener has the call's trace last
                waits = sum(s[0] == "wait" for s in traces[-1].spans)
                counts.setdefault(inst.name, []).append((len(found), waits))
                sites.update(f"{os.path.basename(w.filename)}:{w.lineno}"
                             for w in found)
        finally:
            torch.cuda.set_sync_debug_mode(0)
    return {"per_query": {
                name: {"torch": statistics.fmean(c[0] for c in calls),
                       "waits": statistics.fmean(c[1] for c in calls)}
                for name, calls in counts.items()},
            "sites": sites.most_common(20)}
