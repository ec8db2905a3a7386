"""Spilling: host-RAM partitioned execution (Grace join / grouped agg).

Reference parity: ``spiller/`` (``FileSingleStreamSpiller``,
``GenericPartitioningSpiller``), the HashBuilderOperator spill states
(``operator/HashBuilderOperator.java:155,287-302``) and
``SpillableHashAggregationBuilder``.  The reference spills revocable
memory to local disk; here the scarce resource is device memory and the
spill medium is **host RAM over PCIe**: a spilled partition is a dict of
host tensors, pinned when the data came from a CUDA device, so that
``unspill`` is an asynchronous upload on the current stream.

The partitioned processing loop doubles as the grouped-execution
(``execution/Lifespan.java:26``) analog: every hash partition runs
end-to-end independently, bounding peak device memory to roughly 1/P of
the input.

Partition ids come from the same 62-bit multiplicative key mix the join
uses (``ops/common.py::mix_key_word``), times the golden ratio, top bits
masked: the JAX package's ids exactly.  NULL keys land in one partition
(sentinel word), preserving outer-join semantics within a single partition
pair.  ``spill_partitions`` makes one host sync for the partition counts
and one after its copies (the JAX package makes one per partition): each
partition is one stable compaction of its rows (the compaction kernel),
one gather of every column (the gather kernel) and one copy to the host,
so a partition's rows keep their input order.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, List, Optional, Sequence

import numpy as np
import torch

from ..batch import Column, RecordBatch, gather_columns, round_capacity
from ..ops.common import iota, mix_key_word
from ..ops.segments import compact_indices

# golden-ratio multiplier: decorrelates the mixed key word from the join's
# own table addressing before taking the top partition bits
_GOLD = int(np.uint64(0x9E3779B97F4A7C15).astype(np.int64))


@dataclass
class SpilledBatch:
    """Host-side (spilled) copy of a RecordBatch: the SerializedPage analog.
    ``pinned``: the host tensors are page-locked (they came from a CUDA
    device and go back to one)."""

    columns: Dict[str, tuple]  # name -> (data, validity|None, dictionary, type)
    num_rows: int
    pinned: bool = False
    # a nested (array / map) column's other parts: name -> (lengths,
    # map_values|None); its data is the [n, W] element matrix
    nested: Dict[str, tuple] = field(default_factory=dict)

    def nbytes(self) -> int:
        total = 0
        parts = [(d, v) for d, v, _, _ in self.columns.values()]
        parts += list(self.nested.values())
        for pair in parts:
            for t in pair:
                if t is not None:
                    total += t.numel() * t.element_size()
        return total


def _spilled(cols: Dict[str, Column], n: int, pinned: bool,
             rows: Optional[int] = None) -> SpilledBatch:
    """Enqueue host copies of the first ``rows`` (default all) rows of every
    part of ``cols``."""
    def host(t):
        return None if t is None else _to_host(
            t if rows is None else t[:rows], pinned)

    return SpilledBatch(
        {name: (host(c.data), host(c.validity), c.dictionary, c.type)
         for name, c in cols.items()}, n, pinned,
        {name: (host(c.lengths), host(c.map_values))
         for name, c in cols.items() if c.lengths is not None})


def _to_host(t: torch.Tensor, pinned: bool) -> torch.Tensor:
    """Enqueue a copy of ``t`` into a fresh host tensor (page-locked for a
    CUDA source); the caller synchronises before the host reads it."""
    out = torch.empty(t.shape, dtype=t.dtype, pin_memory=pinned)
    out.copy_(t, non_blocking=pinned)
    return out


def _finish(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.current_stream(device).synchronize()


def _device_of(batch: RecordBatch) -> torch.device:
    return next(iter(batch.columns.values())).data.device


def spill(batch: RecordBatch, num_rows: Optional[int] = None) -> SpilledBatch:
    """Copy the live rows of a batch to host memory (device -> host RAM)."""
    n = int(batch.num_rows) if num_rows is None else num_rows
    device = _device_of(batch)
    out = _spilled(batch.columns, n, device.type == "cuda", rows=n)
    _finish(device)
    return out


def unspill(sp: SpilledBatch, capacity: Optional[int] = None,
            device="cuda") -> RecordBatch:
    """Re-upload a spilled batch into a padded RecordBatch on ``device``:
    asynchronous copies on the current stream from pinned memory, the tail
    past the live rows zeroed."""
    cap = capacity if capacity is not None \
        else round_capacity(max(sp.num_rows, 1))
    device = torch.device(device)
    n = sp.num_rows

    def up(t):
        out = torch.empty((cap,) + tuple(t.shape[1:]), dtype=t.dtype,
                          device=device)
        out[:n].copy_(t, non_blocking=sp.pinned)
        out[n:].zero_()
        return out

    cols = {}
    for name, (data, valid, dic, t) in sp.columns.items():
        lengths, mv = sp.nested.get(name, (None, None))
        cols[name] = Column(up(data), t,
                            validity=None if valid is None else up(valid),
                            dictionary=dic,
                            lengths=None if lengths is None else up(lengths),
                            map_values=None if mv is None else up(mv))
    return RecordBatch(cols, n)


def concat_spilled(parts: Sequence[SpilledBatch]) -> SpilledBatch:
    parts = [p for p in parts if p is not None]
    assert parts
    pinned = all(p.pinned for p in parts)
    names = list(parts[0].columns.keys())

    def cat(ts):
        rows = sum(t.shape[0] for t in ts)
        if ts[0].dim() == 2:  # element matrices: pad to the widest
            w = max(t.shape[1] for t in ts)
            ts = [t if t.shape[1] == w else torch.cat(
                [t, t.new_zeros((t.shape[0], w - t.shape[1]))], dim=1)
                for t in ts]
        out = torch.empty((rows,) + tuple(ts[0].shape[1:]),
                          dtype=ts[0].dtype, pin_memory=pinned)
        return torch.cat(ts, out=out)

    nested = {}
    for name in parts[0].nested:
        lens = [p.nested[name][0] for p in parts]
        mvs = [p.nested[name][1] for p in parts]
        nested[name] = (cat(lens), None if mvs[0] is None else cat(mvs))
    cols = {}
    for name in names:
        datas, valids = [], []
        has_valid = any(p.columns[name][1] is not None for p in parts)
        dic = parts[0].columns[name][2]
        t = parts[0].columns[name][3]
        for p in parts:
            data, valid, pdic, _ = p.columns[name]
            datas.append(data)
            if has_valid:
                valids.append(valid if valid is not None
                              else torch.ones((data.shape[0],),
                                              dtype=torch.bool))
            if pdic is not None:
                dic = pdic  # identical across partitions of one source
        cols[name] = (cat(datas), cat(valids) if has_valid else None, dic, t)
    return SpilledBatch(cols, sum(p.num_rows for p in parts), pinned, nested)


def choose_partitions(total_bytes: int, threshold: int,
                      max_partitions: int = 256) -> int:
    """Power-of-two partition count so each partition ~ threshold/2."""
    target = max(threshold // 2, 1)
    p = 1
    while p * target < total_bytes and p < max_partitions:
        p <<= 1
    return max(p, 2)


def partition_ids(key_cols: Sequence[Column], ranges, num_rows,
                  n_partitions: int) -> torch.Tensor:
    """Partition id per row from the mixed key word (one elementwise pass).

    NULL keys share the sentinel word and therefore one partition, which
    keeps outer-join semantics local to a single partition pair.
    """
    word = mix_key_word(key_cols, ranges, num_rows)
    h = word * _GOLD  # int64 multiply wraps
    return (h >> 32) & (n_partitions - 1)  # n_partitions is a power of two


def spill_partitions(batch: RecordBatch, key_names: Sequence[str], ranges,
                     n_partitions: int) -> List[SpilledBatch]:
    """Hash-partition a batch and spill each partition to host RAM, rows of
    a partition in input order."""
    n = batch.capacity()
    device = _device_of(batch)
    pinned = device.type == "cuda"
    cols = batch.columns
    live = iota(n, device) < batch.num_rows
    pids = partition_ids([batch[k] for k in key_names], ranges,
                         batch.num_rows, n_partitions)
    pids = torch.where(live, pids, n_partitions)
    counts = torch.bincount(pids, minlength=n_partitions + 1).tolist()
    out = []
    for p in range(n_partitions):
        c = counts[p]
        if c == 0:
            out.append(_spilled(cols, 0, pinned, rows=0))
            continue
        idx, _ = compact_indices(pids == p, c)
        out.append(_spilled(gather_columns(cols, idx), c, pinned))
    _finish(device)
    return out
