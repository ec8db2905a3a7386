"""Partial/final decomposition of an aggregation.

Of the reference's multi-host engine (``presto1_tpu/exec/dist_engine.py``:
fragmenter, scheduler, page pulls over HTTP) this module holds only what the
planner needs: ``split_aggregate``, which the rule that pushes an
aggregation through UNION ALL (``sql/matching.py``) uses to cut one
Aggregate into per-branch partials and one final.  The rest of the
multi-host engine is ROADMAP A12.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import List, Optional, Tuple

from ..expr import ir
from ..sql import logical as L
from ..types import BIGINT, DOUBLE


@dataclass
class AggSplit:
    """Partial/final decomposition of one AggCall."""
    partial: List[L.AggCall]              # worker-side calls
    final: List[L.AggCall]                # coordinator-side calls
    # expression assembling the original symbol from final symbols (for avg)
    assemble: Optional[Tuple[str, ir.Expr]] = None


def split_aggregate(agg: L.Aggregate) -> Optional[Tuple[L.Aggregate,
                                                        L.Aggregate,
                                                        Optional[L.Project]]]:
    """Aggregate -> (partial, final, optional assembling Project).  None if
    not splittable (distinct aggs)."""
    if any(a.distinct for a in agg.aggs):
        return None
    partial_calls: List[L.AggCall] = []
    final_calls: List[L.AggCall] = []
    assembles: List[Tuple[str, ir.Expr]] = []
    from ..ops.hashagg import AggSpec

    for a in agg.aggs:
        if a.fn in ("sum", "count", "count_star"):
            # the partial computes the sum; the final sums partials.  The
            # partial's type is the PHYSICAL output type
            # (AggSpec.output_type), not the planner's logical a.type: the
            # engine sums decimals exactly at decimal(38,s) even where the
            # planner types the result DOUBLE (scale>4), and typing the
            # partial column as DOUBLE makes the final treat raw scaled
            # ints as doubles -- a 10^scale blowup.
            pt = AggSpec(a.fn, None if a.arg is None else _FakeCol(a.arg.type),
                         "").output_type()
            partial_calls.append(L.AggCall(a.symbol, a.fn, a.arg, False, pt))
            final_calls.append(L.AggCall(
                a.symbol, "sum", ir.ColumnRef(a.symbol, pt), False, pt))
        elif a.fn in ("min", "max"):
            partial_calls.append(L.AggCall(a.symbol, a.fn, a.arg, False,
                                           a.type))
            final_calls.append(L.AggCall(
                a.symbol, a.fn, ir.ColumnRef(a.symbol, a.type), False,
                a.type))
        elif a.fn == "avg":
            ssym, csym = a.symbol + "$sum", a.symbol + "$cnt"
            arg_t = a.arg.type
            sum_t = AggSpec("sum", _FakeCol(arg_t), "").output_type()
            partial_calls.append(L.AggCall(ssym, "sum", a.arg, False, sum_t))
            partial_calls.append(L.AggCall(csym, "count", a.arg, False,
                                           BIGINT))
            final_calls.append(L.AggCall(
                ssym, "sum", ir.ColumnRef(ssym, sum_t), False, sum_t))
            final_calls.append(L.AggCall(
                csym, "sum", ir.ColumnRef(csym, BIGINT), False, BIGINT))
            num = ir.Call("cast", (ir.ColumnRef(ssym, sum_t),), DOUBLE)
            den = ir.Call("cast", (ir.ColumnRef(csym, BIGINT),), DOUBLE)
            assembles.append((a.symbol, ir.Call("/", (num, den), DOUBLE)))
        else:
            return None
    partial = L.Aggregate(agg.child, agg.group, partial_calls, agg.primary)
    # the final consumes the merged partial batches
    final = L.Aggregate(agg.child, agg.group, final_calls, agg.primary)
    project = None
    if assembles:
        outputs: List[Tuple[str, ir.Expr]] = []
        made = dict(assembles)
        for s in agg.group:
            outputs.append((s, ir.ColumnRef(s, agg.child.schema[s])))
        for a in agg.aggs:
            if a.symbol in made:
                outputs.append((a.symbol, made[a.symbol]))
            else:
                outputs.append((a.symbol, ir.ColumnRef(a.symbol, a.type)))
        project = L.Project(final, outputs)
    return partial, final, project


class _FakeCol:
    """Adapter so AggSpec.output_type() can be reused for logical typing."""

    def __init__(self, t):
        self.type = t
