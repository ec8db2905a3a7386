"""Window functions: partitioned and ordered evaluation over one sort.

The reference's WindowOperator materialises a PagesIndex per partition and
walks frames row by row (``operator/WindowOperator.java``,
``operator/window/``).  Here the whole batch is sorted once by (partition
keys, order keys); partitions and peer groups become segments of the sorted
arrangement, so:

* row_number  = position - partition start
* rank        = peer-group start - partition start + 1
* dense_rank  = peer boundaries since the partition start
* ntile(b)    = arithmetic on the position within the partition
* lag/lead    = shifted reads guarded by the partition bounds
* first/last/nth_value = reads at the frame's end points
* framed sum/count/avg = differences of prefix sums at the frame's ends
* framed min/max       = a doubling sparse table queried at the frame's ends

Segment starts and ends are boundary flags, a prefix sum into a segment id,
the compaction kernel over the flags (``kernels/scatter.py::compact``) and a
gather at the segment id -- no running-max scan, which torch runs in one
block over a long row on CUDA.  The sparse table is read through the
gather kernel's ``take_along_axis``; the permuted inputs move through
``gather_rows``; the results return to row order through
``scatter_distinct``, whose targets (a permutation) are distinct.  Nothing
reads a value back to the host: sizes and table levels follow from the
capacity alone.

Frame support: ROWS with any bound combination; RANGE with UNBOUNDED
PRECEDING / CURRENT ROW / UNBOUNDED FOLLOWING (offset RANGE frames are
rejected at plan time).  The JAX package's ``ops/window.py`` is the
reference of every result.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from ..batch import Column, RecordBatch, take_clamped
from ..types import BIGINT, SqlType
from .common import INT64_MAX, iota, pack_key_words, sort_permutation
from .kernels.gather import gather_rows, take_along_axis
from .kernels.scatter import MAX_COLUMNS, scatter_distinct
from .segments import compact_indices
from .sort import SortKey, _sortable

# frame spec: (unit, start_kind, start_val, end_kind, end_val)
# kinds: 'up' unbounded preceding | 'p' N preceding | 'c' current row |
#        'f' N following | 'uf' unbounded following
Frame = Tuple[str, str, Optional[int], str, Optional[int]]


@dataclass
class WindowCall:
    fn: str  # row_number|rank|dense_rank|percent_rank|cume_dist|ntile|lag|
    #          lead|first_value|last_value|nth_value|sum|min|max|count|avg
    input: Optional[Column]
    name: str
    type: SqlType = None
    frame: Optional[Frame] = None
    default: Optional[Column] = None  # lag/lead third argument
    param: Optional[int] = None  # lag/lead offset, nth_value n, ntile buckets


def _boundaries(words: Sequence[torch.Tensor]) -> torch.Tensor:
    """True where a sorted row starts a new run of ``words``."""
    n = words[0].shape[0]
    b = torch.zeros((n,), dtype=torch.bool, device=words[0].device)
    b[:1].fill_(True)  # a fill: assigning a Python scalar would sync
    for w in words:
        b[1:] |= w[1:] != w[:-1]
    return b


def _segment_bounds(b: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """(start, exclusive end) of the segment each sorted row lies in, for
    the boundary flags ``b``."""
    n = b.shape[0]
    seg = torch.cumsum(b, 0) - 1  # int64 segment id of each row
    starts, count = compact_indices(b, n)
    # segment s ends where segment s + 1 starts; the last one at n
    nxt = torch.cat([starts[1:], starts.new_full((1,), n)])
    ends = torch.where(iota(n, b.device) + 1 < count, nxt, n)
    start, end = gather_rows([starts, ends], seg)
    return start, end


def _levels(n: int) -> int:
    """Levels of the doubling table over ``n`` rows (1, 2, 4, ... < n)."""
    levels, w = 1, 1
    while w < n:
        levels += 1
        w <<= 1
    return levels


def sparse_table(vals: torch.Tensor, op, sentinel) -> torch.Tensor:
    """[levels, n]: level k holds ``op`` over ``vals[i : i + 2**k]``
    (``sentinel`` past the end)."""
    n = vals.shape[0]
    levels = _levels(n)
    tab = torch.empty((levels, n), dtype=vals.dtype, device=vals.device)
    tab[0] = vals
    sent = torch.full((), sentinel, dtype=vals.dtype, device=vals.device)
    w = 1
    for k in range(1, levels):
        prev = tab[k - 1]
        op(prev[:n - w], prev[w:], out=tab[k, :n - w])
        op(prev[n - w:], sent, out=tab[k, n - w:])
        w <<= 1
    return tab


def sparse_table_query(tab: torch.Tensor, fs: torch.Tensor,
                       fe: torch.Tensor, op) -> torch.Tensor:
    """``op`` over ``vals[fs:fe]`` per row (where fe > fs) from the table of
    ``sparse_table``: the two power-of-two blocks that cover the range, both
    read in one launch of ``take_along_axis``.  The level is the integer
    bit length of the range's length less one."""
    levels, n = tab.shape
    length = torch.clamp(fe - fs, min=1)
    powers = torch.bitwise_left_shift(
        torch.ones((), dtype=torch.int64, device=tab.device),
        torch.arange(1, levels, dtype=torch.int64, device=tab.device))
    k = torch.searchsorted(powers, length, right=True)  # floor(log2(len))
    pw = torch.bitwise_left_shift(torch.ones_like(k), k)
    at = torch.stack([k * n + fs, k * n + torch.clamp(fe - pw, 0, n - 1)])
    both = take_along_axis(tab.view(-1, 1), at.view(-1, 1), axis=0)
    return op(both[:fs.shape[0], 0], both[fs.shape[0]:, 0])


def _scatterable(v: torch.Tensor) -> torch.Tensor:
    """``v`` in a dtype the scatter kernel moves (int32, int64, float64)."""
    if v.dtype in (torch.int32, torch.int64, torch.float64):
        return v.contiguous()
    if v.dtype.is_floating_point:
        return v.to(torch.float64)
    return v.to(torch.int64)


def window(
    batch: RecordBatch,
    partition_cols: Sequence[Column],
    partition_ranges,
    order_keys: Sequence[SortKey],
    calls: Sequence[WindowCall],
) -> RecordBatch:
    n = batch.capacity()
    dev = next(iter(batch.columns.values())).data.device
    pos = iota(n, dev)
    if partition_cols:
        part_words = pack_key_words(partition_cols, partition_ranges,
                                    batch.num_rows)
    else:
        part_words = [torch.where(pos >= batch.num_rows, INT64_MAX, 0)]
    order_words = [_sortable(k, n) for k in order_keys]
    keys = list(part_words) + order_words
    perm = sort_permutation(keys)  # stable: ties keep their row order
    sorted_keys = gather_rows([w.contiguous() for w in keys], perm)
    sorted_parts = sorted_keys[:len(part_words)]

    part_b = _boundaries(sorted_parts)
    part_start, part_end = _segment_bounds(part_b)
    peers: Dict[str, torch.Tensor] = {}

    def peer():
        """(boundary flags, start, end) of the peer groups, made once."""
        if not peers:
            peers["b"] = _boundaries(sorted_keys)
            peers["start"], peers["end"] = _segment_bounds(peers["b"])
        return peers["b"], peers["start"], peers["end"]

    # every input column read by a call, permuted in one gather launch
    inputs: List[Column] = []
    for call in calls:
        for c in (call.input, call.default):
            if c is not None and not any(c is d for d in inputs):
                inputs.append(c)
    sources = []
    for c in inputs:
        sources.append(c.data.contiguous())
        if c.validity is not None:
            sources.append(c.validity.contiguous())
    moved = iter(gather_rows(sources, perm))
    permuted_of = []
    for c in inputs:
        vals = next(moved)
        permuted_of.append((vals, None if c.validity is None
                            else next(moved)))

    def permuted(c: Column):
        return next(p for d, p in zip(inputs, permuted_of) if d is c)

    def frame_bounds(frame: Optional[Frame]):
        """(fs, fe): the frame of each row, clipped to its partition."""
        if frame is None:
            if order_keys:
                frame = ("range", "up", None, "c", None)
            else:
                frame = ("range", "up", None, "uf", None)
        unit, sk, sv, ek, ev = frame
        if unit == "rows":
            s = {"up": part_start, "p": pos - (sv or 0), "c": pos,
                 "f": pos + (sv or 0)}[sk]
            e = {"uf": part_end, "p": pos - (ev or 0) + 1, "c": pos + 1,
                 "f": pos + (ev or 0) + 1}[ek]
        else:  # range / groups restricted to peer-aligned bounds
            s = part_start if sk == "up" else peer()[1]
            e = part_end if ek == "uf" else peer()[2]
        fs = torch.minimum(torch.maximum(s, part_start), part_end)
        fe = torch.minimum(torch.maximum(e, part_start), part_end)
        return fs, fe

    def read_at(c: Column, idx: torch.Tensor):
        """The permuted input's values and validity at ``idx`` (clamped)."""
        vals, cvalid = permuted(c)
        got = gather_rows([vals] if cvalid is None else [vals, cvalid], idx)
        tvalid = (torch.ones((n,), dtype=torch.bool, device=dev)
                  if cvalid is None else got[1])
        return got[0], tvalid

    results = []  # (values, validity or None, dictionary, out dtype)
    for call in calls:
        dictionary = None
        out_dtype = (call.input.data.dtype
                     if call.fn in ("lag", "lead", "first_value",
                                    "last_value", "nth_value", "min", "max")
                     and call.input is not None else None)
        if call.fn == "row_number":
            v, valid = pos - part_start + 1, None
        elif call.fn == "rank":
            v, valid = peer()[1] - part_start + 1, None
        elif call.fn == "dense_rank":
            upto = torch.cumsum(peer()[0], 0)
            v, valid = upto - take_clamped(upto, part_start) + 1, None
        elif call.fn == "percent_rank":
            # (rank - 1) / (partition rows - 1); 0 for 1-row partitions
            # (reference: operator/window/PercentRankFunction.java)
            size = part_end - part_start
            v = ((peer()[1] - part_start).to(torch.float64)
                 / torch.clamp(size - 1, min=1))
            v, valid = torch.where(size <= 1, 0.0, v), None
        elif call.fn == "cume_dist":
            # rows <= current peer group / partition rows
            # (reference: operator/window/CumulativeDistributionFunction)
            size = torch.clamp(part_end - part_start, min=1)
            v = (peer()[2] - part_start).to(torch.float64) / size
            valid = None
        elif call.fn == "ntile":
            b = int(call.param or 1)
            idx = pos - part_start
            size = torch.clamp(part_end - part_start, min=1)
            q = torch.div(size, b, rounding_mode="floor")
            r = torch.remainder(size, b)
            thresh = r * (q + 1)
            lo = torch.div(idx, torch.clamp(q + 1, min=1),
                           rounding_mode="floor")
            hi = r + torch.div(idx - thresh, torch.clamp(q, min=1),
                               rounding_mode="floor")
            v, valid = torch.where(idx < thresh, lo, hi) + 1, None
        elif call.fn in ("lag", "lead"):
            k = int(call.param if call.param is not None else 1)
            if call.fn == "lag":
                idx = pos - k
                ok = idx >= part_start
            else:
                idx = pos + k
                ok = idx < part_end
            taken, tvalid = read_at(call.input, idx)
            if call.default is not None:
                dvals, dvalid = permuted(call.default)
                v = torch.where(ok, taken, dvals.to(taken.dtype))
                valid = torch.where(
                    ok, tvalid,
                    torch.ones((n,), dtype=torch.bool, device=dev)
                    if dvalid is None else dvalid)
            else:
                v = torch.where(ok, taken, torch.zeros(
                    (), dtype=taken.dtype, device=dev))
                valid = ok & tvalid
            dictionary = call.input.dictionary
        elif call.fn in ("first_value", "last_value", "nth_value"):
            fs, fe = frame_bounds(call.frame)
            empty = fe <= fs
            if call.fn == "first_value":
                idx, ok = fs, ~empty
            elif call.fn == "last_value":
                idx, ok = fe - 1, ~empty
            else:
                idx = fs + int(call.param or 1) - 1
                ok = (~empty) & (idx < fe)
            taken, tvalid = read_at(call.input, idx)
            v = torch.where(ok, taken, torch.zeros(
                (), dtype=taken.dtype, device=dev))
            valid = ok & tvalid
            dictionary = call.input.dictionary
        elif call.fn in ("sum", "avg", "count", "min", "max"):
            c = call.input
            fs, fe = frame_bounds(call.frame)
            empty = fe <= fs
            vals, cvalid = (None, None) if c is None else permuted(c)
            zero = torch.zeros((), dtype=torch.int64, device=dev)
            if cvalid is None:  # every row in the frame counts
                cnt = torch.where(empty, zero, fe - fs)
            else:
                cps = torch.zeros((n + 1,), dtype=torch.int64, device=dev)
                torch.cumsum(cvalid, 0, out=cps[1:])
                at_e, at_s = gather_rows([cps], fe)[0], \
                    gather_rows([cps], fs)[0]
                cnt = torch.where(empty, zero, at_e - at_s)
            if call.fn == "count":
                v, valid = cnt, None
            elif call.fn in ("sum", "avg"):
                dt = (torch.float64 if vals.dtype.is_floating_point
                      else torch.int64)
                base = vals.to(dt)
                if cvalid is not None:
                    base = torch.where(cvalid, base,
                                       torch.zeros((), dtype=dt, device=dev))
                ps = torch.zeros((n + 1,), dtype=dt, device=dev)
                torch.cumsum(base, 0, out=ps[1:])
                v = gather_rows([ps], fe)[0] - gather_rows([ps], fs)[0]
                valid = cnt > 0
                # zero where NULL: a frame of NULLs leaves the rounding
                # residue of a double prefix sum there
                v = torch.where(valid, v, torch.zeros((), dtype=dt,
                                                      device=dev))
                if call.fn == "avg":
                    t = c.type
                    scale = 10 ** t.scale if t.kind == "decimal" else 1  # type: ignore[attr-defined]
                    v = v.to(torch.float64) / (torch.clamp(cnt, min=1)
                                               * scale)
            else:  # min / max over the sparse table, one per call
                op = torch.minimum if call.fn == "min" else torch.maximum
                if vals.dtype.is_floating_point:
                    sent = np.inf if call.fn == "min" else -np.inf
                    work = vals
                else:
                    work = vals.to(torch.int64)
                    sent = INT64_MAX if call.fn == "min" else -INT64_MAX
                if cvalid is not None:
                    work = torch.where(cvalid, work, torch.full(
                        (), sent, dtype=work.dtype, device=dev))
                tab = sparse_table(work.contiguous(), op, sent)
                v = sparse_table_query(tab, fs, fe, op)
                del tab
                valid = cnt > 0
                v = torch.where(valid, v, torch.zeros(
                    (), dtype=v.dtype, device=dev))
                dictionary = None if c is None else c.dictionary
        else:
            raise NotImplementedError(f"window function {call.fn}")
        results.append((v, valid, dictionary, out_dtype))

    # back to row order: the sorted row i is row perm[i] of the input
    payload = []
    for v, valid, _, _ in results:
        payload.append(_scatterable(v))
        if valid is not None:
            payload.append(valid.to(torch.int32))
    back = []
    for at in range(0, len(payload), MAX_COLUMNS):
        back += scatter_distinct(perm, payload[at:at + MAX_COLUMNS], n)
    cols = dict(batch.columns)
    i = 0
    for call, (v, valid, dictionary, out_dtype) in zip(calls, results):
        arr = back[i]
        i += 1
        bvalid = None
        if valid is not None:
            bvalid = back[i].to(torch.bool)
            i += 1
        t = call.type or BIGINT
        if out_dtype is not None:
            arr = arr.to(out_dtype)
        elif t.kind == "double":
            arr = arr.to(torch.float64)
        else:
            arr = arr.to(torch.int64)
        cols[call.name] = Column(arr, t, validity=bvalid,
                                 dictionary=dictionary)
    return RecordBatch(cols, batch.num_rows)
