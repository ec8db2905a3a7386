"""Executor: operator executions per query that recompute a subtree the
same statement had already computed (a grouping-sets query's shared child,
once per set), a mean over the traced instances.

Each traced instance is sent once more with the engine's tracing on, and
restored after.  A replayed statement has no operator spans: its
``op:GraphReplay`` span carries the counts its capture made; an eagerly
run one has an ``op:<Node>`` span per execution, whose detail is the plan
node's id within the statement (equal subtrees share it).  A program
whose spans carry neither gives None."""

from __future__ import annotations

import statistics
from typing import Optional

from .. import harness


def reruns(trace) -> Optional[int]:
    """One statement's reruns, or None where its spans do not say."""
    ops = [s for s in trace.spans if s[0].startswith("op:")]
    replays = [s for s in ops if s[0] == "op:GraphReplay"]
    if replays:
        counts = [s[4] for s in replays]
        if not all(isinstance(c, dict) and "reruns" in c for c in counts):
            return None
        return sum(c["reruns"] for c in counts)
    if not ops or any(s[4] is None for s in ops):
        return None
    seen, out = set(), 0
    for s in ops:
        out += s[4] in seen
        seen.add(s[4])
    return out


def read(run):
    engine = run.engine
    if not hasattr(engine, "trace") or not run.traced:
        return None
    was = engine.trace
    per, by_template = [], {}
    engine.trace = True
    try:
        for inst in run.traced:
            try:
                out = engine.sql(inst.text)
                out.to_pylist()
            except Exception as e:  # counted by the window already
                harness.log(operator_reruns_query_failed=inst.name,
                            error=repr(e))
                return None
            trace = getattr(out, "trace", None)
            n = None if trace is None else reruns(trace)
            if n is None:
                return None
            per.append(n)
            by_template.setdefault(inst.name, []).append(n)
    finally:
        engine.trace = was
    harness.log(operator_reruns={k: statistics.fmean(v)
                                 for k, v in sorted(by_template.items())})
    return statistics.fmean(per)

