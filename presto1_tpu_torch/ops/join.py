"""Equi-join: sorted build side + vectorized binary-search probe.

The reference's join (``operator/PagesHash.java:76`` linear-probe hash table,
``operator/LookupJoinOperator.java:285`` per-row probe loop with PositionLinks
chains) is replaced by a fully data-parallel design:

* **build**: sort the packed build keys once -- duplicates are adjacent, so
  Trino's PositionLinks chain becomes a contiguous range.
* **probe**: one vectorized ``searchsorted`` gives every probe row the start
  of its match range, and the build side's run lengths give its count.
* **expand**: the classic prefix-sum expansion turns per-row match counts
  into flat output pairs inside a static-capacity buffer.

1:N matches, LEFT padding, SEMI/ANTI and residual (non-equi) conditions all
fall out of the same three steps.  N:1 inner and semi/anti joins take
``merge_join`` (one stable sort of both key sets, a prefix count, two
compactions).  Every row move goes through the gather kernel and every
compaction through the scatter kernel (``ops/kernels/``); sorts are
``torch.sort`` (``ops/common.sort_multi``) and the probe is
``torch.searchsorted``.
"""

from __future__ import annotations

from typing import Optional, Sequence, Tuple

import numpy as np
import torch

from ..batch import Column, RecordBatch, gather_columns, take_clamped
from ..expr.ir import Expr
from ..expr.eval import eval_predicate
from .common import (
    INT64_MAX, iota, mix_key_word, narrow_i32, pack_key_words,
    searchsorted_fast, sort_multi,
)
from .kernels.gather import gather_rows
from .kernels.scatter import scatter_distinct
from .segments import compact_indices, sorted_segment_sum

_I32 = np.iinfo(np.int32)


def _key_widths(ranges) -> int:
    widths = 0
    for lo_, hi_ in ranges:
        widths += max(int(hi_ - lo_ + 2).bit_length(), 1)
    return widths


def _sentinel(dtype) -> int:
    """The dead-row key of a packed (and possibly narrowed) key word."""
    return INT64_MAX if dtype == torch.int64 else int(_I32.max)


def merge_join_applicable(kind: str, ranges, residual,
                          build_unique: bool) -> bool:
    """True when the single-merge-sort join formulation applies: narrow
    (packable) keys, no residual, and either an N:1 inner join or a
    semi/anti join (any build cardinality).  The decision depends only on
    plan-static facts, so eager discovery and compiled replay always
    agree."""
    if residual is not None or _key_widths(ranges) > 63:
        return False
    return kind in ("semi", "anti") or (kind == "inner" and build_unique)


def merge_join(
    probe: RecordBatch,
    build: RecordBatch,
    probe_keys: Sequence[str],
    build_keys: Sequence[str],
    kind: str,  # 'inner' (build-unique) | 'semi' | 'anti'
    ranges: Sequence[Tuple[int, int]],
    capacity: int,
    probe_mask=None,
) -> RecordBatch:
    """Equi-join as ONE stable sort + ONE compaction.

    The packed build and probe keys sort TOGETHER once (stable, build
    entries first within equal keys); match structure then falls out of
    dense scans:

    * because keys ascend, the key and origin of the most recent build
      entry decide every probe entry: a running count of build entries
      indexes the build entries compacted in sorted order (Trino's per-row
      hash lookup -- ``operator/PagesHash.java:157`` -- becomes a prefix
      sum, a compaction and a gather; the JAX package's two running-max
      scans compute the same, but ``torch.cummax`` over one long row runs
      in one block on CUDA);
    * an upstream Filter fuses as ``probe_mask``: dead rows pack to the
      sentinel, sort to the end, and fall out of the compaction the join
      already pays;
    * the compaction keeps surviving rows in KEY order: the output is
      sorted by the join key, which the executor records in the order
      chains (downstream aggregations on the same key take the clustered,
      sort-free path).

    Payload never rides the sort: it carries two int32 bookkeeping
    operands; survivors gather once at [capacity].
    """
    np_, nb = probe.capacity(), build.capacity()
    total = np_ + nb
    assert total < (1 << 31), "merge_join addresses rows in int32"
    device = probe.columns[probe_keys[0]].data.device
    widths = _key_widths(ranges)
    bcols = [build[k] for k in build_keys]
    pcols = [probe[k] for k in probe_keys]
    bk = pack_key_words(bcols, ranges, build.num_rows, null_high=True)[0]
    pk = pack_key_words(pcols, ranges, probe.num_rows, mask=probe_mask)[0]
    bk = narrow_i32(bk, widths)
    pk = narrow_i32(pk, widths)

    key = torch.cat([bk, pk])
    origin = torch.arange(total, dtype=torch.int32, device=device)
    s_key, s_origin = sort_multi((key, origin), num_keys=1)
    is_build = s_origin < nb
    sentinel = _sentinel(s_key.dtype)
    # the most recent build entry before each position (the reference's two
    # running-max scans): build entries seen so far, and the build entries
    # themselves in sorted order, compacted by that count
    seen = torch.cumsum(is_build, 0)
    rank = seen - 1
    b_key = scatter_distinct(rank, s_key, nb, is_build)
    b_origin = scatter_distinct(rank, s_origin, nb, is_build)
    last_bkey, borigin = gather_rows([b_key, b_origin],
                                     torch.clamp(rank, min=0))
    is_probe = ~is_build
    real = s_key != sentinel
    matched = is_probe & real & (seen > 0) & (last_bkey == s_key)
    if kind == "anti":
        keep = is_probe & real & ~matched
    else:
        keep = matched
    # the stable partition on ~keep (a second sort in the reference):
    # a prefix sum + scatter keeps the live rows in key order
    pos, count = compact_indices(keep, capacity)
    at_origin, at_borigin = gather_rows([s_origin, borigin], pos)
    pidx = torch.clamp(at_origin - nb, 0, max(np_ - 1, 0))
    out_live = iota(capacity, device) < count

    cols = gather_columns(probe.columns, pidx)
    if kind == "inner":
        bidx = torch.clamp(at_borigin, 0, max(nb - 1, 0))
        cols.update(gather_columns(build.columns, bidx, valid=out_live))
    return RecordBatch(cols, count)


def _probe_ranges(probe, build, probe_keys, build_keys, ranges,
                  build_sorted: bool = False, probe_mask=None):
    """Returns (lo, counts, bperm, live, needs_verify).  Wide composite
    keys (>63 bits) fall back to a 62-bit mix whose candidate matches the
    caller verifies against the real key columns.

    The probe is a left and a right search into the sorted build keys:
    the range between them is every match (reference analog:
    PagesHash.getAddressIndex + PositionLinks chain walk,
    ``operator/PagesHash.java:157-169``)."""
    np_, nb = probe.capacity(), build.capacity()
    bcols = [build[k] for k in build_keys]
    pcols = [probe[k] for k in probe_keys]
    device = pcols[0].data.device
    widths = _key_widths(ranges)
    if widths <= 63:
        bk = pack_key_words(bcols, ranges, build.num_rows, null_high=True)[0]
        pk = pack_key_words(pcols, ranges, probe.num_rows,
                            mask=probe_mask)[0]
        bk = narrow_i32(bk, widths)
        pk = narrow_i32(pk, widths)
        needs_verify = False
    else:
        bk = mix_key_word(bcols, ranges, build.num_rows, null_high=True)
        pk = mix_key_word(pcols, ranges, probe.num_rows, mask=probe_mask)
        needs_verify = True
    idx32 = torch.arange(nb, dtype=torch.int32, device=device)
    if build_sorted and not needs_verify:
        # build rows already ascending in the (single) key with live rows
        # a prefix (exec/ordering.py proves it): packing is monotone and
        # dead-row sentinels trail, so the sorted view IS the input
        sorted_bk, bperm = bk, idx32
    else:
        sorted_bk, bperm = sort_multi((bk, idx32), num_keys=1)
    # int32 positions throughout
    lo = searchsorted_fast(sorted_bk, pk, side="left").to(torch.int32)
    live = iota(np_, device) < probe.num_rows
    if probe_mask is not None:
        live = live & probe_mask

    # match counts: the run of equal build keys at lo ends where a right
    # search puts the probe key (the JAX package derives it from the build
    # side's run lengths by a reversed running minimum instead, which
    # ``torch.cummin`` computes in one block on CUDA)
    hi = searchsorted_fast(sorted_bk, pk, side="right").to(torch.int32)
    # build-side sentinels sort to the end (null_high): a probe sentinel
    # (dead row / null key) equals them but is masked by `live` and `real`
    real = pk != _sentinel(sorted_bk.dtype)
    counts = torch.where(live & real & (lo < nb),
                         (hi - lo).to(torch.int64), 0)
    return lo, counts, bperm, live, needs_verify


def _expand(probe, build, lo, counts_real, counts_emit, bperm, capacity):
    """Prefix-sum expansion of match ranges into a flat pair batch.

    The per-pair bookkeeping lookups (offsets/counts/lo at pidx) ride ONE
    call of the gather kernel (four int32 sources, one launch)."""
    np_ = probe.capacity()
    nb = build.capacity()
    device = lo.device
    offsets = torch.cumsum(counts_emit, 0)
    total = offsets[-1] if np_ > 0 else torch.zeros(
        (), dtype=torch.int64, device=device)
    out_i = iota(capacity, device)
    off32 = torch.clamp(offsets, max=capacity).to(torch.int32)
    if capacity < (1 << 31):
        # int32 search: offsets clipped at capacity keep every "<= j"
        # relation for j < capacity (overflow trips the capacity guard)
        pidx = searchsorted_fast(off32, out_i.to(torch.int32), side="right")
    else:
        pidx = searchsorted_fast(offsets, out_i, side="right")
    pidx = torch.clamp(pidx, 0, np_ - 1).to(torch.int32)

    g_off, g_emit, g_real, g_lo = gather_rows(
        [off32, counts_emit.to(torch.int32), counts_real.to(torch.int32),
         lo.to(torch.int32)], pidx)
    start = g_off - g_emit
    k = out_i.to(torch.int32) - start
    matched = k < g_real
    bpos = take_clamped(bperm, torch.clamp(g_lo + k, 0, max(nb - 1, 0)))
    out_live = out_i < total

    cols = gather_columns(probe.columns, pidx)
    cols.update(gather_columns(build.columns, bpos, valid=matched))
    return RecordBatch(cols, total), pidx, matched, out_live, offsets


def hash_join(
    probe: RecordBatch,
    build: RecordBatch,
    probe_keys: Sequence[str],
    build_keys: Sequence[str],
    kind: str,  # 'inner' | 'left' | 'semi' | 'anti'
    ranges: Sequence[Tuple[int, int]],
    capacity: int,
    residual: Optional[Expr] = None,
    stats: Optional[dict] = None,
    build_unique: bool = False,
    build_sorted: bool = False,
    probe_mask=None,
) -> RecordBatch:
    assert probe_mask is None or kind in ("inner", "semi", "anti"), \
        "a fused probe mask would drop LEFT/FULL null-extended rows"
    if merge_join_applicable(kind, ranges, residual, build_unique):
        return merge_join(probe, build, probe_keys, build_keys, kind,
                          ranges, capacity, probe_mask=probe_mask)

    lo, counts, bperm, live, needs_verify = _probe_ranges(
        probe, build, probe_keys, build_keys, ranges,
        build_sorted=build_sorted, probe_mask=probe_mask)

    if build_unique and residual is None and not needs_verify \
            and kind == "left":
        # N:1 LEFT fast path -- a pure in-place lookup, no expansion and
        # no compaction: every probe row emits exactly one output row
        nb = build.capacity()
        matched = (counts > 0) & live
        bpos = take_clamped(bperm, torch.clamp(lo, 0, max(nb - 1, 0)))
        cols = dict(probe.columns)
        cols.update(gather_columns(build.columns, bpos, valid=matched))
        return RecordBatch(cols, probe.num_rows)
    np_ = probe.capacity()
    if needs_verify:
        from ..expr.ir import ColumnRef, call as ir_call

        verify = None
        for pk_name, bk_name in zip(probe_keys, build_keys):
            eq = ir_call("=", ColumnRef(pk_name, probe[pk_name].type),
                         ColumnRef(bk_name, build[bk_name].type))
            verify = eq if verify is None else ir_call("and", verify, eq)
        residual = verify if residual is None else ir_call(
            "and", verify, residual)

    if kind in ("semi", "anti") and residual is None:
        hit = counts > 0
        mask = (hit if kind == "semi" else ~hit) & live
        idx, n = compact_indices(mask, capacity)
        return probe.gather(idx, n)

    if kind in ("semi", "anti"):
        # expand all candidate pairs, apply residual, reduce per probe row.
        # pair rows are ordered by probe row, so the per-probe "any pair
        # passes" reduction is a prefix-sum difference (no scatter).
        pairs, pidx, matched, out_live, offsets = _expand(
            probe, build, lo, counts, counts, bperm, capacity)
        if stats is not None:
            stats["pairs_total"] = pairs.num_rows
        rm = eval_predicate(residual, pairs) & matched & out_live
        hits = sorted_segment_sum(
            rm.to(torch.int64),
            torch.clamp(offsets - counts, 0, capacity),
            torch.clamp(offsets, 0, capacity))
        hit = hits > 0
        mask = (hit if kind == "semi" else ~hit) & live
        idx, n = compact_indices(mask, np_)
        return probe.gather(idx, n)

    if kind == "inner":
        pairs, pidx, matched, out_live, _ = _expand(
            probe, build, lo, counts, counts, bperm, capacity)
        if stats is not None:
            stats["pairs_total"] = pairs.num_rows
        if residual is not None:
            rm = eval_predicate(residual, pairs) & out_live
            idx, n = compact_indices(rm, capacity)
            return pairs.gather(idx, n)
        return pairs

    if kind == "left":
        counts_emit = torch.where(live, torch.clamp(counts, min=1), 0)
        pairs, pidx, matched, out_live, offsets = _expand(
            probe, build, lo, counts, counts_emit, bperm, capacity)
        if stats is not None:
            stats["pairs_total"] = pairs.num_rows
        if residual is None:
            return pairs
        # LEFT with residual (also: wide->63-bit keys whose candidates need
        # re-verification).  Keep pairs that pass; a probe row with no
        # passing pair keeps its FIRST pair slot, null-extended on the
        # build side.  Reference analog: LookupJoinOperator's
        # outerJoinCurrentPosition (operator/LookupJoinOperator.java) --
        # here the "emitted a row?" flag is a segmented reduction.
        rm = eval_predicate(residual, pairs) & matched & out_live
        starts = torch.clamp(offsets - counts_emit, 0, capacity)
        ends = torch.clamp(offsets, 0, capacity)
        hits = sorted_segment_sum(rm.to(torch.int64), starts, ends)
        hit_at, start_at = gather_rows([hits > 0, starts], pidx)
        is_first = iota(capacity, pidx.device) == start_at
        keep = (rm | (is_first & ~hit_at)) & out_live
        cols = {}
        for name, c in pairs.columns.items():
            if name in build.columns:
                v = rm if c.validity is None else (c.validity & rm)
                cols[name] = Column(c.data, c.type, validity=v,
                                    dictionary=c.dictionary)
            else:
                cols[name] = c
        masked = RecordBatch(cols, pairs.num_rows)
        idx, n = compact_indices(keep, capacity)
        return masked.gather(idx, n)

    raise NotImplementedError(f"join kind {kind}")


def cross_join(probe: RecordBatch, build: RecordBatch,
               capacity: int) -> RecordBatch:
    """Cartesian product; the planner only emits this for tiny build sides
    (scalar subqueries), where it is a broadcast."""
    nb_rows = build.num_rows
    np_ = probe.capacity()
    if isinstance(nb_rows, int) and nb_rows == 1:
        cols = dict(probe.columns)
        for name, c in build.columns.items():
            data = c.data[:1].expand(
                (np_,) + tuple(c.data.shape[1:])).contiguous()
            validity = None
            if c.validity is not None:
                validity = c.validity[:1].expand((np_,)).contiguous()
            cols[name] = Column(data, c.type, validity=validity,
                                dictionary=c.dictionary)
        return RecordBatch(cols, probe.num_rows)
    nb = build.capacity()
    out_i = iota(capacity, next(iter(probe.columns.values())).data.device)
    # a count of 0 divides by 1: every output row is dead then anyway
    if isinstance(nb_rows, int):
        div = max(nb_rows, 1)
    else:
        div = torch.clamp(nb_rows, min=1)
    pidx = torch.clamp(torch.div(out_i, div, rounding_mode="floor"), 0,
                       np_ - 1)
    bpos = torch.remainder(out_i, div)
    total = probe.num_rows * nb_rows
    cols = gather_columns(probe.columns, pidx)
    cols.update(gather_columns(build.columns,
                               torch.clamp(bpos, 0, nb - 1)))
    return RecordBatch(cols, total)
