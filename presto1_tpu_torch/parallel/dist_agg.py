"""Distributed aggregation: partial per shard -> gather -> final combine.

The reference splits aggregations into PARTIAL and FINAL stages around a
FIXED_HASH exchange (planner rule PushPartialAggregationThroughExchange,
``operator/HashAggregationOperator`` steps).  Here the partial aggregation
runs once for each shard of the mesh over its rows of the columns, the
per-shard group tables (tiny compared to the input) are concatenated, and
the same operator re-aggregates them -- sum/count re-sum, min/max
re-min/max, avg is decomposed into sum+count and divided at the end.

A partial that is NULL on one shard (a group whose values there are all
NULL) stays NULL into the final combine, so it neither adds a zero to a
sum nor a zero to a min or max.  The JAX package drops the partials'
validity there (ROADMAP C17).
"""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence, Tuple

import torch

from ..batch import Column, RecordBatch, concat_many
from ..ops.hashagg import AggSpec, group_aggregate
from ..types import BIGINT, DOUBLE
from .dist_join import _on, _rows_on_shard, _shard, prep_shard_rows


def _decompose(aggs: Sequence[AggSpec]) -> Tuple[List[AggSpec], list]:
    """Partial agg specs + recipe to rebuild finals from partial columns."""
    partial: List[AggSpec] = []
    recipe = []  # (final_name, kind, partial names)
    for i, a in enumerate(aggs):
        if a.fn in ("sum", "min", "max"):
            pname = f"__p{i}"
            partial.append(AggSpec(a.fn, a.input, pname))
            recipe.append((a.name, a.fn, [pname]))
        elif a.fn in ("count", "count_star"):
            pname = f"__p{i}"
            partial.append(AggSpec(a.fn, a.input, pname))
            recipe.append((a.name, "sum", [pname]))
        elif a.fn == "avg":
            sname, cname = f"__ps{i}", f"__pc{i}"
            partial.append(AggSpec("sum", a.input, sname))
            partial.append(AggSpec("count", a.input, cname))
            recipe.append((a.name, "avg_combine", [sname, cname]))
        else:
            raise NotImplementedError(a.fn)
    return partial, recipe


def _sharded_column(mesh, c: Column, rows: int) -> List[Column]:
    """A column's data and validity row-sharded, one Column a shard."""
    data = _shard(mesh, c.data, rows)
    valid = [None] * mesh.size if c.validity is None \
        else _shard(mesh, c.validity, rows, False)
    return [Column(d, c.type, validity=v, dictionary=c.dictionary)
            for d, v in zip(data, valid)]


def distributed_group_aggregate(
    mesh,
    key_names: Sequence[str],
    columns: Dict[str, Column],
    aggs: Sequence[AggSpec],
    num_rows,
    ranges,
    max_groups: int,
    mask: Optional[torch.Tensor] = None,
    carry_names: Sequence[str] = (),
) -> RecordBatch:
    """Group-aggregate row-sharded columns over the mesh.

    ``columns`` hold full-table device tensors (they get row-sharded onto
    the mesh); ``mask`` optionally fuses an upstream filter.  The output
    lies on the first shard's device.
    """
    n = mesh.size
    partial_specs, recipe = _decompose(aggs)
    cap = next(iter(columns.values())).data.shape[0]
    rows = prep_shard_rows(cap, n)
    sharded = {name: _sharded_column(mesh, c, rows)
               for name, c in columns.items()}
    # partial-agg inputs are evaluated Columns already; validity rides
    # along -- count/sum must skip NULLs (e.g. LEFT-join padding)
    inputs = {s.name: _sharded_column(mesh, s.input, rows)
              for s in partial_specs if s.input is not None}
    masks = [None] * n if mask is None else _shard(mesh, mask, rows, False)

    partials = []
    for s in range(n):
        specs = [AggSpec(p.fn, None if p.input is None else inputs[p.name][s],
                         p.name) for p in partial_specs]
        partials.append(group_aggregate(
            [(k, sharded[k][s]) for k in key_names], specs,
            _rows_on_shard(num_rows, s, rows), ranges, max_groups,
            mask=masks[s], carry=[(k, sharded[k][s]) for k in carry_names]))

    # the per-shard group tables' live rows, one after the other (carry
    # columns -- group columns functionally dependent on the primary keys
    # -- ride through as representative-row payloads, as in
    # group_aggregate)
    dev = mesh.devices[0]
    table = concat_many([_on(p, dev) for p in partials], n * max_groups)
    fcols = {name: table[name] for name in list(key_names)
             + list(carry_names)}
    final_specs = []
    for fname, kind, pnames in recipe:
        if kind == "avg_combine":
            sum_col = _typed(table[pnames[0]], partial_specs, pnames[0])
            cnt_col = Column(table[pnames[1]].data, BIGINT)
            final_specs.append(AggSpec("sum", sum_col, pnames[0] + "_f"))
            final_specs.append(AggSpec("sum", cnt_col, pnames[1] + "_f"))
        else:
            col = _typed(table[pnames[0]], partial_specs, pnames[0])
            final_specs.append(AggSpec(kind, col, fname))

    keys = [(k, fcols[k]) for k in key_names]
    out = group_aggregate(keys, final_specs, table.num_rows, ranges,
                          max_groups,
                          carry=[(k, fcols[k]) for k in carry_names])

    # stitch avg columns
    cols = {k: out[k] for k in list(key_names) + list(carry_names)}
    for fname, kind, pnames in recipe:
        if kind == "avg_combine":
            s = out[pnames[0] + "_f"]
            c = out[pnames[1] + "_f"]
            t = s.type
            scale = 10 ** t.scale if t.kind == "decimal" else 1  # type: ignore[attr-defined]
            data = s.data.to(torch.float64) / (
                torch.clamp(c.data, min=1) * scale)
            cols[fname] = Column(data, DOUBLE, validity=c.data > 0)
        else:
            cols[fname] = out[fname]
    return RecordBatch(cols, out.num_rows)


def _typed(col: Column, partial_specs, name) -> Column:
    """A partial column under its partial's output type, its validity
    kept."""
    return Column(col.data, _partial_type(partial_specs, name),
                  validity=col.validity)


def _partial_type(partial_specs, name):
    for s in partial_specs:
        if s.name == name:
            return AggSpec(s.fn, s.input, s.name).output_type()
    raise KeyError(name)


def distributed_global_aggregate(
    mesh,
    aggs: Sequence[AggSpec],
    num_rows,
    mask: Optional[torch.Tensor] = None,
) -> RecordBatch:
    """Ungrouped aggregation over the mesh: a degenerate group-by on a
    constant key (the reference's single-group AggregationOperator with a
    partial->final exchange; with one group the exchange is an
    all-reduce).

    Caller must guarantee num_rows > 0 -- SQL's empty-input global
    aggregate (one row of NULL/0) stays on the single-device path."""
    src = next((s.input.data for s in aggs if s.input is not None), None)
    if src is not None:
        cap, dev = src.shape[0], src.device
    elif mask is not None:
        cap, dev = mask.shape[0], mask.device
    else:
        # count(*) alone: a row of the constant key for every input row
        # (the JAX package's 128 rows count at most 128 a shard: C18)
        cap, dev = max(int(num_rows), 1), mesh.devices[0]
    const = Column(torch.zeros((cap,), dtype=torch.int64, device=dev),
                   BIGINT)
    out = distributed_group_aggregate(
        mesh, ["__g"], {"__g": const}, aggs, num_rows, [(0, 0)], 128,
        mask=mask)
    cols = {n: c for n, c in out.columns.items() if n != "__g"}
    return RecordBatch(cols, out.num_rows)
