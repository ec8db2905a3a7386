"""Distributed equi-join: hash repartition both sides over the mesh, join
locally per shard.

The FIXED_HASH_DISTRIBUTION partitioned join of the reference
(``DetermineJoinDistributionType`` -> ``PartitionedOutputOperator`` shuffle
-> per-worker ``PagesHash`` build/probe): rows of both inputs are routed by
key hash with one all-to-all each, then every shard runs the same join the
single-device engine uses (``ops.join.hash_join``), on its co-partitioned
slice.  Multi-column and string (dictionary-coded) keys ride the same path:
the key columns are bit-packed into one routing word
(``ops/common.pack_key_words``; >63-bit composites use the 62-bit mix whose
collisions only cost routing balance, never correctness -- the local join
re-verifies real keys).  Quotas and capacities come from the discovery
pass (exact histograms on the host -- the planner's stats job).

Broadcast distribution (``FIXED_BROADCAST`` / BroadcastOutputBuffer in the
reference) is ``broadcast_hash_join``: the small build side is replicated,
only the probe side is row-sharded, and no exchange moves data at all.

Every shard's result is its own batch; ``_stitch`` concatenates their live
rows in shard order with the dynamic-copy kernel, after the stage's one
read of the device counts (dropped rows, the largest shard's rows, the
total).
"""

from __future__ import annotations

from dataclasses import replace
from typing import Dict, List, Sequence, Tuple

import numpy as np
import torch

from ..batch import Column, RecordBatch, concat_many
from ..ops.common import iota, mix_key_word, pack_key_words
from ..ops.join import hash_join
from ..ops.kernels.gather import gather_rows
from ..ops.segments import compact_indices
from .exchange import _MIX, all_to_all_by_key


class JoinCapacityError(RuntimeError):
    """A shard's join output exceeded local_capacity; retry with
    ``needed`` (the true max per-shard row count)."""

    def __init__(self, needed: int):
        super().__init__(f"per-shard join output needs capacity {needed}")
        self.needed = needed


def route_word(batch: RecordBatch, key_names: Sequence[str], ranges,
               num_rows) -> torch.Tensor:
    """One int64 routing word per row: the packed composite key (or its
    62-bit mix when too wide).  Equal keys always map to equal words."""
    cols = [batch[k] for k in key_names]
    widths = 0
    for lo_, hi_ in ranges:
        widths += max(int(hi_ - lo_ + 2).bit_length(), 1)
    if widths <= 63:
        return pack_key_words(cols, ranges, num_rows)[0]
    return mix_key_word(cols, ranges, num_rows)


def prep_shard_rows(cap: int, n_dev: int) -> int:
    """Rows per shard EXACTLY as ``_prep`` lays them out (padded to a
    multiple of ``n_dev*128``).  Quota histograms must use this same
    boundary: an unpadded ``cap // n_dev`` drifts from the real layout,
    and with KEY-CLUSTERED inputs (merge-join outputs are sorted by key)
    the drift concentrates whole runs into the wrong source bucket --
    observed in the JAX package as a 16-row exchange overflow on mesh
    TPC-H Q5."""
    pad = (-cap) % (n_dev * 128)
    return max((cap + pad) // n_dev, 1)


def exchange_quota(word_host: np.ndarray, n_rows: int, n_dev: int,
                   shard_rows: int) -> int:
    """Exact max rows any shard sends to any destination (discovery-time
    histogram -- the stats the reference's planner gets from connectors).
    The destination is ``exchange.partition_of``'s, in numpy."""
    h = (word_host[:n_rows].astype(np.int64) * np.int64(_MIX)) >> 33
    dest = h % n_dev
    src = np.arange(n_rows) // shard_rows
    counts = np.bincount(src * n_dev + dest, minlength=(n_dev + 1) * n_dev)
    return int(counts.max()) if n_rows else 0


# the parts of a column as they travel, under the wire names of the JAX
# package (data under the column's own name, validity under "__v_<name>")
# and two more for nested columns
_WIRE = (("data", ""), ("validity", "__v_"), ("lengths", "__l_"),
         ("map_values", "__m_"))


def _shard(mesh, data: torch.Tensor, rows: int, fill=0) -> List[torch.Tensor]:
    """``data`` split into ``rows``-row shards in row order, one on each
    shard's device; rows past the end are ``fill`` (only the shards past
    the data are made anew, the rest are views)."""
    out = []
    for s, dev in enumerate(mesh.devices):
        part = data[s * rows:(s + 1) * rows]
        if part.shape[0] < rows:
            part = torch.cat([part, torch.full(
                (rows - part.shape[0],) + tuple(data.shape[1:]), fill,
                dtype=data.dtype, device=data.device)])
        out.append(part.to(dev, non_blocking=True))
    return out


def _prep(mesh, batch: RecordBatch):
    """Every part of every column row-sharded over the mesh: (one dict of
    wire arrays a shard, column meta, names of the columns with a validity
    mask, rows a shard)."""
    rows = prep_shard_rows(batch.capacity(), mesh.size)
    arrays: List[Dict[str, torch.Tensor]] = [{} for _ in mesh.devices]
    vnames = []
    for name, c in batch.columns.items():
        for part, prefix in _WIRE:
            t = getattr(c, part)
            if t is None:
                continue
            if part == "validity":
                vnames.append(name)
            fill = False if part == "validity" else 0
            for s, sh in enumerate(_shard(mesh, t, rows, fill)):
                arrays[s][prefix + name] = sh
    meta = {name: (c.type, c.dictionary) for name, c in batch.columns.items()}
    return arrays, meta, vnames, rows


def _rows_on_shard(num_rows, s: int, rows: int):
    """Live rows of shard ``s`` when ``num_rows`` rows are laid out
    ``rows`` a shard (an int, or a 0-d tensor for a device count)."""
    v = num_rows - s * rows
    if isinstance(v, torch.Tensor):
        return torch.clamp(v, 0, rows)
    return min(max(v, 0), rows)


def _rebuild(arrays, meta, vnames, extra_mask, num_rows) -> RecordBatch:
    """Columns back from the wire arrays; ``extra_mask`` is ANDed into the
    validity of the columns that carry one (dead rows need no more: join
    key sentinels handle liveness)."""
    cols = {}
    for name, (t, dic) in meta.items():
        v = arrays.get("__v_" + name)
        if name in vnames and extra_mask is not None and v is not None:
            v = v & extra_mask
        cols[name] = Column(arrays[name], t, validity=v, dictionary=dic,
                            lengths=arrays.get("__l_" + name),
                            map_values=arrays.get("__m_" + name))
    return RecordBatch(cols, num_rows)


def _compacted(arrays, mask, meta, vnames) -> RecordBatch:
    """Received rows to the front (stable), every wire array through one
    gather launch."""
    cap = mask.shape[0]
    idx, n = compact_indices(mask, cap)
    names = list(arrays)
    moved = dict(zip(names, gather_rows([arrays[k] for k in names], idx)))
    return _rebuild(moved, meta, vnames, iota(cap, mask.device) < n, n)


def _on(batch: RecordBatch, dev) -> RecordBatch:
    """``batch`` with every part on ``dev`` (no copy where it lies)."""
    cols = {}
    for name, c in batch.columns.items():
        parts = {p: getattr(c, p).to(dev, non_blocking=True)
                 for p, _ in _WIRE if getattr(c, p) is not None}
        cols[name] = replace(c, **parts)
    nr = batch.num_rows
    if isinstance(nr, torch.Tensor):
        nr = nr.to(dev, non_blocking=True)
    return RecordBatch(cols, nr)


def _local_join(probe, build, probe_keys, build_keys, kind, ranges,
                capacity, residual, build_unique):
    """One shard's ``hash_join`` and the rows it needed: the larger of its
    output rows and the candidate pairs it expanded (a residual filters
    pairs after they are cut at ``capacity``), a 0-d tensor."""
    stats: dict = {}
    out = hash_join(probe, build, list(probe_keys), list(build_keys), kind,
                    ranges, capacity, residual=residual, stats=stats,
                    build_unique=build_unique)
    dev = next(iter(out.columns.values())).data.device
    need = torch.as_tensor(out.num_rows, device=dev).to(torch.int64)
    if "pairs_total" in stats:
        need = torch.maximum(need, torch.as_tensor(
            stats["pairs_total"], device=dev).to(torch.int64))
    return out, need


def _stitch(mesh, outs: Sequence[RecordBatch], local_capacity: int,
            needs=None, dropped=None, quotas=None) -> RecordBatch:
    """Concatenate per-shard results in shard order into
    ``[n * local_capacity]``, after the stage's one read of the device
    counts: an exchange that dropped rows raises, and a shard that needed
    more than ``local_capacity`` rows (``needs``, else its output rows)
    raises ``JoinCapacityError`` (the analog of the compiled executor's
    capacity re-discovery loop).  Each shard's live rows are taken at its
    own capacity (the JAX package strides the results by
    ``local_capacity``, which misreads a narrower one: ROADMAP C21)."""
    dev = mesh.devices[0]
    outs = [_on(b, dev) for b in outs]

    def stacked(values):
        return torch.stack([torch.as_tensor(v).to(dev).reshape(())
                            .to(torch.int64) for v in values])

    read = [stacked([b.num_rows for b in outs]).sum(),
            stacked(needs or [b.num_rows for b in outs]).max()]
    if dropped is not None:
        read.append(stacked(dropped).sum())
    got = torch.stack(read).tolist()
    total, mx = got[0], got[1]
    if dropped is not None and got[2]:
        raise RuntimeError(
            f"exchange overflow: {got[2]} rows exceeded the src->dst quotas "
            f"{quotas} -- the discovery histogram under-sized the shuffle "
            f"(skewed keys?); re-run with larger quotas")
    if mx > local_capacity:
        raise JoinCapacityError(mx)
    out = concat_many(outs, mesh.size * local_capacity)
    return RecordBatch(out.columns, total)


def distributed_hash_join(
    mesh,
    probe: RecordBatch,
    build: RecordBatch,
    probe_keys: Sequence[str],
    build_keys: Sequence[str],
    kind: str,
    ranges,
    quotas: Tuple[int, int],
    local_capacity: int,
    residual=None,
    build_unique: bool = False,
) -> RecordBatch:
    """Join two full-table batches by repartitioning over the mesh.

    Output is the concatenation of the per-shard join results (row count
    on the host).  Any equi-key arity/type, LEFT/FULL/SEMI/ANTI, residual
    predicates and the N:1 fast path all delegate to the local
    ``ops.join.hash_join`` per shard.
    """
    n = mesh.size
    pq, bq = quotas
    parr, pmeta, pvn, p_shard_rows = _prep(mesh, probe)
    barr, bmeta, bvn, b_shard_rows = _prep(mesh, build)

    def local_word(arrs, meta, keys, nrows):
        cols = {k: Column(arrs[k], meta[k][0],
                          validity=arrs.get("__v_" + k),
                          dictionary=meta[k][1]) for k in keys}
        return route_word(RecordBatch(cols, nrows), keys, ranges, nrows)

    p_valid = [_rows_on_shard(probe.num_rows, s, p_shard_rows)
               for s in range(n)]
    b_valid = [_rows_on_shard(build.num_rows, s, b_shard_rows)
               for s in range(n)]
    pword = [local_word(parr[s], pmeta, list(probe_keys), p_valid[s])
             for s in range(n)]
    bword = [local_word(barr[s], bmeta, list(build_keys), b_valid[s])
             for s in range(n)]
    precv, _pk, pmask, pdrop = all_to_all_by_key(parr, pword, p_valid, mesh,
                                                 pq)
    brecv, _bk, bmask, bdrop = all_to_all_by_key(barr, bword, b_valid, mesh,
                                                 bq)
    outs, needs = [], []
    for s in range(n):
        pb = _compacted(precv[s], pmask[s], pmeta, pvn)
        bb = _compacted(brecv[s], bmask[s], bmeta, bvn)
        out, need = _local_join(pb, bb, probe_keys, build_keys, kind, ranges,
                                local_capacity, residual, build_unique)
        outs.append(out)
        needs.append(need)
    return _stitch(mesh, outs, local_capacity, needs=needs,
                   dropped=pdrop + bdrop, quotas=quotas)


def broadcast_hash_join(
    mesh,
    probe: RecordBatch,
    build: RecordBatch,
    probe_keys: Sequence[str],
    build_keys: Sequence[str],
    kind: str,
    ranges,
    local_capacity: int,
    residual=None,
    build_unique: bool = False,
) -> RecordBatch:
    """Replicated-build join: no exchange at all -- the build side is
    broadcast (FIXED_BROADCAST_DISTRIBUTION), the probe stays row-sharded,
    each shard joins its slice.  Valid for inner/left/semi/anti (every
    probe row lives on exactly one shard); FULL OUTER must repartition."""
    if kind == "full":
        raise ValueError("broadcast join cannot emit build-side unmatched "
                         "rows exactly once; use distributed_hash_join")
    parr, pmeta, pvn, p_shard_rows = _prep(mesh, probe)
    outs, needs = [], []
    for s, dev in enumerate(mesh.devices):
        pb = _rebuild(parr[s], pmeta, pvn, None,
                      _rows_on_shard(probe.num_rows, s, p_shard_rows))
        out, need = _local_join(pb, _on(build, dev), probe_keys, build_keys,
                                kind, ranges, local_capacity, residual,
                                build_unique)
        outs.append(out)
        needs.append(need)
    return _stitch(mesh, outs, local_capacity, needs=needs)
