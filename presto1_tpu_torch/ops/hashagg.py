"""Group-by aggregation: dense small domains, else sort + segmented
reduction.

The reference's ``HashAggregationOperator`` / ``GroupByHash``
(``core/trino-main/.../operator/BigintGroupByHash.java:168`` -- murmur hash +
linear-probe insert per row) is a scalar-at-a-time design.  Here grouping is

* **dense** -- a key domain of at most ``DENSE_MAX_GROUPS`` words (TPC-H
  Q1's 3x2 flags) is its own group id: one pass of the hand-written kernel
  ``ops/kernels/dense_group_agg.py`` over the rows gives every group's
  count, first row and sums;
* **sorted** -- otherwise the packed key word(s) are sorted with the
  aggregate inputs riding as payload, segment boundaries come from a scan of
  the sorted words, and every sum is a difference of one prefix sum:

      pack keys -> sort_multi -> boundaries -> segment_{sum,min,max}

Either way groups come out in packed-key order (``exec/ordering.py``
depends on it).

Decimal sums are exact: 64-bit inputs are split into 32-bit limbs that are
summed separately and recombined, so no intermediate overflows at any row
count (the reference engine sums DOUBLEs and accepts fp error; exactness is
a policy win, SURVEY.md section 7).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional, Sequence, Tuple

import numpy as np
import torch

from ..batch import Column, RecordBatch, gather_columns, take_clamped
from ..types import BIGINT, DOUBLE, REAL, DecimalType, SqlType
from .common import INT64_MAX, iota, pack_key_words, sort_multi
from .kernels.dense_group_agg import dense_group_agg
from .kernels.gather import gather_rows
from .segments import (
    compact_indices, minmax_by_value_sort, sorted_segment_sum,
    sorted_segment_sum_multi,
)


PERCENTILE_FNS = ("approx_percentile", "median")


@dataclass
class AggSpec:
    fn: str  # 'sum'|'count'|'count_star'|'min'|'max'|'avg'|percentile fns
    input: Optional[Column]  # evaluated argument (None for count_star)
    name: str
    param: Optional[float] = None  # percentile fraction

    def output_type(self) -> SqlType:
        if self.fn in ("count", "count_star"):
            return BIGINT
        t = self.input.type
        if self.fn == "avg":
            return DOUBLE
        if self.fn == "sum":
            if t.kind == "decimal":
                # exact at every scale (reference: Decimals.java sums at
                # decimal(38,s)); the device repr is an 18-digit int64, so
                # sums that cannot be PROVEN in-range carry an overflow
                # guard instead of degrading to DOUBLE
                return DecimalType(38, t.scale)  # type: ignore[attr-defined]
            if t.kind in ("integer", "smallint", "tinyint"):
                return BIGINT
            if t.kind == "real":
                return REAL
            return t
        return t  # min/max


def _sum_provably_safe(t, n_rows: int) -> bool:
    """True when an int64 accumulator cannot overflow: worst-case unscaled
    magnitude (10^precision, capped at the 18-digit device repr) times the
    row capacity stays inside int64 with a 5% margin.  SF1 lineitem
    (8.4M rows of decimal(12,2)) is provably safe; SF10 is not -- the
    guarded limb path."""
    p = getattr(t, "precision", 18)
    return (10 ** min(p, 18)) * max(n_rows, 1) < int(0.95 * 2 ** 63)


_LIMB = 1 << 32
_LIMB_MASK = (1 << 32) - 1


def _guard_limb_total(slo, shi, checks):
    """Exact int64 total from 32-bit limb sums; appends a device-side guard
    that the mathematical total fits the device decimal (the executor's
    overflow_checks mechanism raises host-side after its one readback)."""
    if checks is not None:
        approx = (shi.to(torch.float64) * 4294967296.0
                  + slo.to(torch.float64))
        checks.append(torch.all(torch.abs(approx) < 9.0e18))
    return shi * _LIMB + slo


def _group_structure(key_words, max_groups: int, payload=(),
                     clustered: bool = False):
    """Sort the packed key word(s); derive segment bounds.  ``payload``
    tensors ride the sort as extra operands.

    ``clustered=True`` asserts equal keys are ALREADY adjacent (input
    physically sorted/clustered on the group keys -- exec/ordering.py
    proves it from connector sort metadata): the multi-operand sort
    disappears entirely; only the boundary scan and the compaction of the
    boundary positions remain (StreamingAggregationOperator analog)."""
    n = key_words[0].shape[0]
    device = key_words[0].device
    nw = len(key_words)
    if clustered:
        sorted_words, order = key_words, iota(n, device)
        sorted_payload = tuple(payload)
    else:
        out = sort_multi(tuple(key_words) + (iota(n, device),)
                         + tuple(payload), num_keys=nw)
        sorted_words, order = out[:nw], out[nw]
        sorted_payload = out[nw + 1:]
    boundary = torch.zeros((n,), dtype=torch.bool, device=device)
    boundary[:1] = True
    for w in sorted_words:
        prev = torch.cat([torch.full((1,), -1, dtype=torch.int64,
                                     device=device), w[:-1]])
        boundary = boundary | (w != prev)
    real = sorted_words[0] != INT64_MAX
    gid_raw = torch.cumsum(boundary, dim=0) - 1
    num_groups = torch.sum(boundary & real)
    gid_sorted = torch.where(real, gid_raw, max_groups)
    # segment bounds without a search: gids are CONSECUTIVE integers
    # (cumsum of boundary), so group g starts at the position of the g-th
    # boundary -- a stable compaction of the boundary flags (the reference
    # sorts them; prefix sum + scatter is the same permutation's head)
    n_real = torch.sum(real.to(torch.int64))
    bsel, _ = compact_indices(boundary & real, max_groups)
    live = iota(max_groups, device) < num_groups
    starts = torch.where(live, bsel, n_real)
    ends = torch.cat([starts[1:], torch.full((1,), n, dtype=torch.int64,
                                             device=device)])
    ends = torch.where(live, torch.minimum(ends, n_real), n_real)
    if clustered:  # order is the identity -- no gather needed
        repr_idx = torch.clamp(starts, 0, n - 1)
    else:
        repr_idx = take_clamped(order, starts)
    return order, gid_sorted, num_groups, starts, ends, repr_idx, sorted_payload


def _exact_sum_f64(vals_i64, starts, ends):
    """Overflow-proof int64 segmented sum, recombined in float64."""
    slo = sorted_segment_sum(vals_i64 & _LIMB_MASK, starts, ends)
    shi = sorted_segment_sum(vals_i64 >> 32, starts, ends)
    return shi.to(torch.float64) * 4294967296.0 + slo.to(torch.float64)


def _collect_plans(aggs, n_rows: int, isum, fsum, minmax=None):
    """Plan every aggregate as requests for per-group reductions.

    Every sum-like reduction (sums, counts, avg numerators / denominators,
    32-bit limbs of overflow-proof sums) is asked of the caller, who says
    where its result will stand:

    * ``isum(op, data, valid)`` -> column among the int64 sums; ``op`` is
      ``"count"`` (``data`` is None: rows where ``valid`` holds), ``"sum"``,
      ``"low"`` (``x & 0xFFFFFFFF``) or ``"high"`` (``x >> 32``) of the
      int64-widened ``data`` over the rows where ``valid`` (or None) holds;
    * ``fsum(data, valid)`` -> column among the float64 sums;
    * ``minmax(fn, column)`` -> the payload of a min / max plan, beside
      the column of its valid-row count (None when the caller computes
      both from the column itself).

    The sort branch turns a request into a payload operand of the grouping
    sort, the dense branch into a slot of its kernel; both finish the plans
    (``(spec, kind, payload)`` per aggregate) with ``_sum_outputs``.
    """
    plans = []
    for spec in aggs:
        fn = spec.fn
        if fn == "count_star":
            plans.append((spec, "count_star", None))
            continue
        c = spec.input
        valid = c.validity
        cnt_ix = isum("count", None, valid) if valid is not None else None
        if fn == "count":
            plans.append((spec, "count", cnt_ix))
            continue
        if fn in ("min", "max"):
            plans.append((spec, fn,
                          (minmax(fn, c), cnt_ix) if minmax else None))
            continue
        # sum / avg
        t = c.type
        if t.kind == "double":
            plans.append((spec, "fsum", (fsum(c.data, valid), cnt_ix)))
            continue
        out_t = spec.output_type()
        if fn == "avg" or out_t.kind == "double":
            kind = "limb"
        elif (out_t.kind == "decimal"
              and not _sum_provably_safe(t, n_rows)):
            # exact wide-decimal sum: limb accumulation + overflow guard
            kind = "limb_exact"
        else:
            plans.append((spec, "isum", (isum("sum", c.data, valid),
                                         cnt_ix)))
            continue
        plans.append((spec, kind, (isum("low", c.data, valid),
                                   isum("high", c.data, valid), cnt_ix)))
    return plans


def _payload_plans(aggs, n_rows: int):
    """``_collect_plans`` for the sort branch: every request becomes a
    full-length int64 or float64 column that rides the grouping sort as a
    payload operand and reduces with one ``sorted_segment_sum_multi`` pass.
    Returns (int columns, float columns, plans)."""
    int_cols, float_cols = [], []

    def live(data, valid):
        if valid is None:
            return data
        return torch.where(valid, data, torch.zeros(
            (), dtype=data.dtype, device=data.device))

    def isum(op, data, valid):
        if op == "count":
            v = valid.to(torch.int64)
        else:
            v = live(data, valid).to(torch.int64)
            if op == "low":
                v = v & _LIMB_MASK
            elif op == "high":
                v = v >> 32
        int_cols.append(v)
        return len(int_cols) - 1

    def fsum(data, valid):
        float_cols.append(live(data, valid).to(torch.float64))
        return len(float_cols) - 1

    plans = _collect_plans(aggs, n_rows, isum, fsum)
    return int_cols, float_cols, plans


def _sum_outputs(plans, sums, fsums, base_cnt, group_live, checks):
    """Output columns of the sum-like plans (count, sum, avg at every
    flavour) from the per-group reduction matrices ``sums`` [G, ki] int64
    and ``fsums`` [G, kf] float64; the plans of other kinds are left to the
    caller.  ``group_live`` (or None) is ANDed into every validity."""

    def cnt_of(cnt_ix):
        if cnt_ix is None:
            return base_cnt
        return sums[:, cnt_ix]

    def nonempty_of(cnt):
        ne = cnt > 0
        return ne if group_live is None else (ne & group_live)

    out = {}
    for spec, kind, payload in plans:
        if kind == "count_star":
            out[spec.name] = Column(base_cnt, BIGINT)
        elif kind == "count":
            out[spec.name] = Column(cnt_of(payload), BIGINT)
        elif kind == "fsum":
            ix, cnt_ix = payload
            cnt = cnt_of(cnt_ix)
            s = fsums[:, ix]
            if spec.fn == "avg":
                s = s / torch.clamp(cnt, min=1)
            out[spec.name] = Column(s, DOUBLE, validity=nonempty_of(cnt))
        elif kind == "limb":
            lo_ix, hi_ix, cnt_ix = payload
            cnt = cnt_of(cnt_ix)
            t = spec.input.type
            total = (sums[:, hi_ix].to(torch.float64) * 4294967296.0
                     + sums[:, lo_ix].to(torch.float64))
            scale = 10 ** t.scale if t.kind == "decimal" else 1  # type: ignore[attr-defined]
            if spec.fn == "avg":
                v = total / (torch.clamp(cnt, min=1) * scale)
            else:
                v = total / scale
            out[spec.name] = Column(v, DOUBLE, validity=nonempty_of(cnt))
        elif kind == "limb_exact":
            lo_ix, hi_ix, cnt_ix = payload
            cnt = cnt_of(cnt_ix)
            total = _guard_limb_total(sums[:, lo_ix], sums[:, hi_ix], checks)
            out[spec.name] = Column(total, spec.output_type(),
                                    validity=nonempty_of(cnt))
        elif kind == "isum":
            ix, cnt_ix = payload
            cnt = cnt_of(cnt_ix)
            out[spec.name] = Column(sums[:, ix], spec.output_type(),
                                    validity=nonempty_of(cnt))
    return out


def _finalize_aggs(plans, sums, fsums, starts, ends, order, key_words,
                   max_groups, checks=None):
    base_cnt = (ends - starts).to(torch.int64)
    sum_out = _sum_outputs(plans, sums, fsums, base_cnt, None, checks)
    out = {}
    for spec, kind, payload in plans:
        if kind not in ("min", "max"):
            out[spec.name] = sum_out[spec.name]
            continue
        c = spec.input
        cnt = base_cnt
        if c.validity is not None:
            # need the count column: recompute via value-sort validity
            # gather the bool, then widen: an eighth of the bytes
            cnt = sorted_segment_sum(
                take_clamped(c.validity, order).to(torch.int64),
                starts, ends)
        nonempty = cnt > 0
        v = minmax_by_value_sort(key_words, c.data, starts, ends,
                                 kind == "min", valid=c.validity)
        v = torch.where(nonempty, v, torch.zeros((), dtype=v.dtype,
                                                 device=v.device))
        out[spec.name] = Column(v, c.type, validity=nonempty,
                                dictionary=c.dictionary)
    return out


def group_aggregate(
    keys: Sequence[Tuple[str, Column]],
    aggs: Sequence[AggSpec],
    num_rows,
    ranges: Sequence[Tuple[int, int]],
    max_groups: int,
    mask: Optional[torch.Tensor] = None,
    carry: Sequence[Tuple[str, Column]] = (),
    checks: Optional[list] = None,
    clustered: bool = False,
) -> RecordBatch:
    """Grouped aggregation.  ``mask`` fuses an upstream filter for free.

    ``clustered=True``: equal key tuples are already adjacent in row order
    (and live rows form a prefix), so the grouping sort is skipped -- see
    ``_group_structure``.  The caller must guarantee the property (the
    executor proves it from connector sort metadata); with a ``mask`` the
    flag is dropped (masked-out rows inside a cluster would surface as
    groups).

    ``checks`` (the executor's overflow_checks list) receives device-side
    guards for wide-decimal sums that cannot be statically proven to fit
    the int64 device decimal.

    ``carry`` columns are functionally dependent on the keys (the optimizer
    proves this via PK/FK analysis): they are not packed or compared, just
    materialised from each group's representative row -- the reason
    Q10-style "group by pk, name, address, ..." queries cost no more than
    "group by pk".
    """
    key_cols = [c for _, c in keys]
    device = key_cols[0].data.device
    # dense fast path: tiny key domains (Q1's 3x2 flags) need no sort at
    # all.  The domain is MIXED-RADIX (product of exact key spans), not the
    # bit-packed power-of-2 domain: Q1 has 12 candidate groups, not 32.
    pctl_specs = [s for s in aggs if s.fn in PERCENTILE_FNS]
    aggs = [s for s in aggs if s.fn not in PERCENTILE_FNS]
    dense_domain = 1
    for lo, hi in ranges:
        dense_domain *= int(hi - lo + 2)  # +1 null slot, +1 exclusive top
        if dense_domain > DENSE_MAX_GROUPS:
            break
    if (not pctl_specs and dense_domain <= DENSE_MAX_GROUPS
            and dense_domain <= max_groups):
        return _dense_group_aggregate(keys, aggs, num_rows, ranges,
                                      max_groups, dense_domain, mask, carry,
                                      checks)
    if clustered and mask is not None:
        clustered = False
    words = pack_key_words(key_cols, ranges, num_rows, mask=mask)
    int_cols, float_cols, plans = _payload_plans(aggs, words[0].shape[0])
    payload = tuple(int_cols) + tuple(float_cols)
    (order, gid_sorted, num_groups, starts, ends, repr_idx,
     sorted_payload) = _group_structure(words, max_groups, payload,
                                        clustered=clustered)
    # value sorts (min/max, percentiles) need a key that is ascending in
    # the SEGMENT order: the packed words after the grouping sort, or the
    # (already nondecreasing) gid stream on the clustered path
    vkeys = (gid_sorted,) if clustered else words
    ni = len(int_cols)
    sums = fsums = None
    if ni:
        sums = sorted_segment_sum_multi(sorted_payload[:ni], starts, ends)
    if float_cols:
        fsums = sorted_segment_sum_multi(sorted_payload[ni:], starts, ends)

    out = {}
    group_live = iota(max_groups, device) < num_groups
    out.update(gather_columns(
        {name: c for name, c in list(keys) + list(carry)}, repr_idx))
    # key columns of dead slots are garbage but num_rows masks them
    agg_out = _finalize_aggs(plans, sums, fsums, starts, ends, order,
                             vkeys, max_groups, checks)
    for name, col in agg_out.items():
        if col.validity is not None:
            col = col.with_data(col.data, col.validity & group_live)
        out[name] = col
    for spec in pctl_specs:
        out[spec.name] = _segment_percentile(spec, vkeys, starts, ends,
                                             group_live)
    return RecordBatch(out, num_groups)


def _percentile_keys(c: Column, valid):
    """The column as an ascending sort key with invalid rows last."""
    xv = c.data
    if xv.dtype.is_floating_point:
        sent = np.inf
    else:
        xv = xv.to(torch.int64)
        sent = INT64_MAX
    if valid is None:
        return xv
    return torch.where(valid, xv, torch.full((), sent, dtype=xv.dtype,
                                             device=xv.device))


def _nearest_rank(spec: AggSpec, cnt):
    p = 0.5 if spec.fn == "median" else float(spec.param)
    pos = torch.round(p * (cnt - 1).to(torch.float64)).to(torch.int64)
    return torch.minimum(torch.clamp(pos, min=0),
                         torch.clamp(cnt - 1, min=0))


def _segment_percentile(spec: AggSpec, words, starts, ends, group_live):
    """Order statistic per group: one extra (word, value) sort, then a
    nearest-rank read at start + round(p * (n_valid - 1)).

    The reference approximates with a qdigest sketch
    (``operator/aggregation/ApproximateLongPercentileAggregations``); the
    sorted-aggregation design makes the exact statistic one sort away, so
    approx_percentile here is exact (documented policy win).  NULLs sort
    to the segment tail via a sentinel and are excluded by the valid
    count.
    """
    c = spec.input
    n = words[0].shape[0]
    device = words[0].device
    valid = c.validity
    xs = _percentile_keys(c, valid)
    vi = (torch.ones((n,), dtype=torch.int32, device=device)
          if valid is None else valid.to(torch.int32))
    out = sort_multi(tuple(words) + (xs, vi), num_keys=len(words) + 1)
    sx, sv = out[-2], out[-1]
    cps = torch.cat([torch.zeros((1,), dtype=torch.int64, device=device),
                     torch.cumsum(sv.to(torch.int64), dim=0)])
    cnt = take_clamped(cps, ends) - take_clamped(cps, starts)
    val = take_clamped(sx, starts + _nearest_rank(spec, cnt))
    validity = (cnt > 0) & group_live
    return Column(val, spec.output_type(), validity=validity,
                  dictionary=c.dictionary)


def _device_for(aggs, num_rows, mask, device):
    if device is not None:
        return device
    if mask is not None:
        return mask.device
    for spec in aggs:
        if spec.input is not None:
            return spec.input.data.device
    if isinstance(num_rows, torch.Tensor):
        return num_rows.device
    raise ValueError("global_aggregate: no tensor to take the device from; "
                     "pass device=")


def global_aggregate(
    aggs: Sequence[AggSpec],
    num_rows,
    capacity: int,
    mask: Optional[torch.Tensor] = None,
    checks: Optional[list] = None,
    device=None,
) -> RecordBatch:
    """Aggregation without GROUP BY -- always exactly one output row."""
    device = _device_for(aggs, num_rows, mask, device)
    live = torch.arange(capacity, device=device) < num_rows
    if mask is not None:
        live = live & mask

    out = {}
    for spec in aggs:
        if spec.fn == "count_star":
            v = torch.sum(live).to(torch.int64)
            out[spec.name] = Column(v[None], BIGINT)
            continue
        c = spec.input
        valid = live if c.validity is None else (live & c.validity)
        cnt = torch.sum(valid).to(torch.int64)
        nonempty = (cnt > 0)[None]
        t = c.type
        if spec.fn == "count":
            out[spec.name] = Column(cnt[None], BIGINT)
        elif spec.fn in ("sum", "avg"):
            out_t = spec.output_type()
            if t.kind == "double":
                s = torch.sum(torch.where(valid, c.data, 0.0))
                v = s / torch.clamp(cnt, min=1) if spec.fn == "avg" else s
                out[spec.name] = Column(v[None], DOUBLE, validity=nonempty)
            else:
                vals = torch.where(valid, c.data.to(torch.int64), 0)
                slo = torch.sum(vals & _LIMB_MASK)
                shi = torch.sum(vals >> 32)
                scale = 10 ** t.scale if t.kind == "decimal" else 1  # type: ignore[attr-defined]
                if spec.fn == "avg":
                    tot = shi.to(torch.float64) * 4294967296.0 + slo.to(torch.float64)
                    v = tot / (torch.clamp(cnt, min=1) * scale)
                    out[spec.name] = Column(v[None], DOUBLE, validity=nonempty)
                elif out_t.kind == "double":
                    tot = shi.to(torch.float64) * 4294967296.0 + slo.to(torch.float64)
                    out[spec.name] = Column((tot / scale)[None], DOUBLE, validity=nonempty)
                else:
                    guards = (None if _sum_provably_safe(t, capacity)
                              else checks)
                    s = _guard_limb_total(slo, shi, guards)
                    out[spec.name] = Column(s[None], out_t, validity=nonempty)
        elif spec.fn in ("min", "max"):
            if t.np_dtype.kind == "f":
                sent = np.inf if spec.fn == "min" else -np.inf
            else:
                info = np.iinfo(t.np_dtype)
                sent = info.max if spec.fn == "min" else info.min
            vals = torch.where(valid, c.data,
                               torch.full((), sent, dtype=c.data.dtype,
                                          device=device))
            v = torch.min(vals) if spec.fn == "min" else torch.max(vals)
            v = torch.where(cnt > 0, v, torch.zeros((), dtype=v.dtype,
                                                    device=device))
            out[spec.name] = Column(v[None], t, validity=nonempty,
                                    dictionary=c.dictionary)
        elif spec.fn in PERCENTILE_FNS:
            sx = torch.sort(_percentile_keys(c, valid))[0]
            v = take_clamped(sx, _nearest_rank(spec, cnt)[None])
            out[spec.name] = Column(v, spec.output_type(),
                                    validity=nonempty,
                                    dictionary=c.dictionary)
        else:
            raise NotImplementedError(spec.fn)
    return RecordBatch(out, 1)


DENSE_MAX_GROUPS = 32


def pack_dense_word(key_cols, ranges, num_rows, mask):
    """Mixed-radix group word, FIRST key most significant (word order =
    lexicographic key order, matching ``pack_key_words``).

    Unlike the bit-packed sort keys, the dense path keeps an accumulator
    per candidate word, so the domain must be tight: the product of exact
    per-key spans, not the next power of two.  Dead or masked-out rows
    get the out-of-domain sentinel (= domain size)."""
    n = len(key_cols[0])
    device = key_cols[0].data.device
    spans = [int(hi - lo + 2) for lo, hi in ranges]  # 0 reserved for NULL
    word = torch.zeros((n,), dtype=torch.int64, device=device)
    stride = 1
    for c, (lo, hi), span in zip(reversed(key_cols), reversed(ranges),
                                 reversed(spans)):
        v = c.data.to(torch.int64) - lo + 1
        v = torch.clamp(v, 0, span - 1)
        if c.validity is not None:
            v = torch.where(c.validity, v, 0)
        word = word + v * stride
        stride *= span
    dead = iota(n, device) >= num_rows
    if mask is not None:
        dead = dead | ~mask
    return torch.where(dead, stride, word)


_KERNEL_DTYPES = (torch.int32, torch.int64, torch.float64)


def _dense_group_aggregate(keys, aggs, num_rows, ranges, max_groups,
                           span, mask, carry, checks=None):
    """Sort-free aggregation over a dense key domain.

    The mixed-radix key word IS the group id.  The reference reduces each
    of the <=32 candidate groups with its own masked pass over every value
    column; here one pass of ``dense_group_agg`` over the rows returns
    every group's count, first row and reductions, reading each column
    once, in the type it is stored in (the 32-bit limbs of overflow-proof
    sums are split inside the kernel).  Output groups are compacted to the
    nonempty ones.
    """
    key_cols = [c for _, c in keys]
    word = pack_dense_word(key_cols, ranges, num_rows, mask)
    n = word.shape[0]
    device = word.device

    # reduction requests: value columns (each handed over once) and slots;
    # ``int_ix`` / ``float_ix`` / ``mm_ix`` give a slot's place among the
    # int64 sums, the float64 sums and the min/max values
    columns, col_of = [], {}
    slots, int_ix, float_ix, mm_ix = [], [], [], []

    def column(data, as_int=False):
        # each distinct column is handed over once, however many slots read it
        as_int = as_int and data.dtype.is_floating_point
        key = (data.data_ptr(), data.dtype, tuple(data.shape), as_int)
        if key not in col_of:
            if as_int:
                data = data.to(torch.int64)  # summed as integers, as cast
            if data.dtype not in _KERNEL_DTYPES:
                data = data.to(torch.float64 if data.dtype.is_floating_point
                               else torch.int64)
            col_of[key] = len(columns)
            columns.append(data.contiguous())
        return col_of[key]

    def slot(places, op, col, valid):
        places.append(len(slots))
        slots.append((op, col, None if valid is None else valid.contiguous()))
        return len(places) - 1

    plans = _collect_plans(
        aggs, n,
        lambda op, data, valid: slot(
            int_ix, op, None if data is None else column(data, True), valid),
        lambda data, valid: slot(float_ix, "sum", column(data), valid),
        lambda fn, c: slot(mm_ix, fn, column(c.data), c.validity))

    agg = dense_group_agg(word, span, columns, slots)

    # compact nonempty groups to the front (span is tiny)
    idx, num_groups = compact_indices(agg.counts > 0, span)
    pad = max_groups - span

    def pad_groups(a):
        if pad > 0:
            a = torch.cat([a, a.new_zeros((pad,) + tuple(a.shape[1:]))])
        return a

    counts_c, reprs_c, table_c = (pad_groups(a) for a in gather_rows(
        [agg.counts, agg.first_row, agg.table], idx))
    reprs_c = torch.clamp(reprs_c, 0, n - 1)
    isums_c = torch.stack([agg.slot(k, table_c) for k in int_ix], dim=1) \
        if int_ix else None
    fsums_c = torch.stack([agg.slot(k, table_c) for k in float_ix], dim=1) \
        if float_ix else None

    out = {}
    group_live = iota(max_groups, device) < num_groups
    out.update(gather_columns(
        {name: c for name, c in list(keys) + list(carry)}, reprs_c))
    sum_out = _sum_outputs(plans, isums_c, fsums_c, counts_c, group_live,
                           checks)
    for spec, kind, payload in plans:
        if kind not in ("min", "max"):
            out[spec.name] = sum_out[spec.name]
            continue
        c = spec.input
        mm, cnt_ix = payload
        v = agg.slot(mm_ix[mm], table_c).to(c.data.dtype)
        # a group of NULLs only is NULL, not the reduction's identity
        # (the JAX package's dense path answers the identity: C20)
        cnt = counts_c if cnt_ix is None else isums_c[:, cnt_ix]
        nonempty = (cnt > 0) & group_live
        v = torch.where(nonempty, v, torch.zeros((), dtype=v.dtype,
                                                 device=device))
        out[spec.name] = Column(v, c.type, validity=nonempty,
                                dictionary=c.dictionary)
    return RecordBatch(out, num_groups)
