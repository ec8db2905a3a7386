"""Grouped aggregation over a dense group-id domain: one pass over the rows.

``dense_group_agg(word, num_groups, columns, slots)``: ``word[i]`` in
``[0, num_groups)`` is row ``i``'s group, any other value marks a dead row
(the engine uses ``num_groups`` itself as the sentinel).  Per group it
returns the row count, the first row's index (``n`` for an empty group) and
one reduction per *slot*.  A slot is ``(op, column, valid)``:

======== ==================================================================
op       value reduced over the group's rows where ``valid`` holds
======== ==================================================================
sum      the column: int32 / int64 / bool widened to int64 (wrapping like
         tensor arithmetic), float64 summed as float64
low      ``x & 0xFFFFFFFF`` of the int64-widened column (low 32-bit limb)
high     ``x >> 32``, arithmetic shift (high limb)
min, max of an int32 / int64 / float64 column (a NaN is passed on)
count    rows where ``valid`` holds (``column`` is None)
======== ==================================================================

``column`` indexes ``columns``, which are read in the type they are stored
in; ``valid`` is a bool tensor or None.  Limbs are split in registers, so the
32-bit limb columns of an overflow-proof decimal sum are never materialised.
With no slot the function is a histogram.

Replaces the histogram probes of the JAX package (``t7`` of
``experiments/pallas_primitives2.py`` and of
``experiments/pallas_primitives3.py``: counts of int32 values over 256 bins by
a one-hot compare and sum per grid step) and the ``span`` masked passes of
``presto1_tpu/ops/hashagg.py::_dense_group_aggregate``, which read every value
column once per candidate group (12 times for TPC-H Q1).

Bound on an H100: memory, each row read once.  The CUDA kernel
(``csrc/dense_group_agg.cu``) gives every warp private accumulators in shared
memory; a warp walks its 32 rows with lane ``k`` owning slot ``k``, so every
accumulator cell has one owner: no atomics, a handful of live groups do not
contend, integer results are exact and float64 sums are reproducible from
run to run (they differ from the plain version's by summation order only).

``dense_group_agg_plain`` is the same function in plain tensor ops, one
masked pass per group as the reference writes it.  The wrapper takes it only
for tensors that lie on the CPU; for CUDA tensors it launches the kernel or
raises.
"""

from __future__ import annotations

import ctypes
from dataclasses import dataclass
from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch

from . import _build

# launches of the CUDA kernel by this module's wrapper (and nothing else)
LAUNCHES = 0

MAX_GROUPS = 256
MAX_COLUMNS = 32
MAX_SLOTS = 64

OPS = ("sum", "low", "high", "min", "max", "count")
Slot = Tuple[str, Optional[int], Optional[torch.Tensor]]

_COL_CODES = {torch.int32: 0, torch.int64: 1, torch.float64: 2,
              torch.bool: 3, torch.uint8: 3}
_TAKE = {"sum": 0, "min": 0, "max": 0, "low": 1, "high": 2, "count": 3}
_REDUCE = {"sum": 0, "low": 0, "high": 0, "count": 0, "min": 1, "max": 2}
_LIMB_MASK = (1 << 32) - 1
_I64 = np.iinfo(np.int64)


@dataclass
class DenseAgg:
    """Result of ``dense_group_agg``: ``counts`` and ``first_row`` are int64
    ``[G]``; ``table`` is int64 ``[G, K]`` holding each slot's accumulator as
    8 raw bytes (``slot`` decodes a column of it, or of a row-gathered copy
    of it, into the slot's own type)."""

    counts: torch.Tensor
    first_row: torch.Tensor
    table: torch.Tensor
    slot_dtypes: List[torch.dtype]

    def slot(self, k: int, table: Optional[torch.Tensor] = None
             ) -> torch.Tensor:
        t = self.table if table is None else table
        raw = t[:, k]
        dt = self.slot_dtypes[k]
        if dt == torch.float64:
            return raw.view(torch.float64)
        if dt == torch.int64:
            return raw
        info = torch.iinfo(dt)  # an empty group holds the int64 identity
        return raw.clamp(info.min, info.max).to(dt)


def _slot_dtype(op: str, col: Optional[torch.Tensor]) -> torch.dtype:
    if op == "count" or op in ("low", "high"):
        return torch.int64
    if col.dtype == torch.float64:
        return torch.float64
    return torch.int64 if op == "sum" else col.dtype


def _check(word, num_groups, columns, slots):
    if not isinstance(word, torch.Tensor) or word.dim() != 1:
        raise ValueError("word: expected a 1-D tensor")
    if word.dtype not in (torch.int32, torch.int64):
        raise TypeError(f"word: dtype {word.dtype} is not int32/int64")
    if not word.is_contiguous():
        raise ValueError("word: tensor is not contiguous")
    if not 1 <= num_groups <= MAX_GROUPS:
        raise ValueError(f"num_groups {num_groups} is not in "
                         f"[1, {MAX_GROUPS}]")
    if len(columns) > MAX_COLUMNS or len(slots) > MAX_SLOTS:
        raise ValueError(f"{len(columns)} columns / {len(slots)} slots: at "
                         f"most {MAX_COLUMNS} / {MAX_SLOTS}")
    n = word.shape[0]

    def same(name, t):
        if not isinstance(t, torch.Tensor) or t.dim() != 1 \
                or t.shape[0] != n:
            raise ValueError(f"{name}: expected a 1-D tensor of length {n}")
        if t.device != word.device:
            raise ValueError(f"{name} on {t.device}, word on {word.device}")
        if not t.is_contiguous():
            raise ValueError(f"{name}: tensor is not contiguous")

    for c, t in enumerate(columns):
        same(f"columns[{c}]", t)
        if t.dtype not in _COL_CODES:
            raise TypeError(f"columns[{c}]: dtype {t.dtype} is not int32, "
                            f"int64, float64 or bool")
    for k, (op, c, valid) in enumerate(slots):
        if op not in OPS:
            raise ValueError(f"slots[{k}]: op {op!r} is not one of {OPS}")
        if op == "count":
            if c is not None:
                raise ValueError(f"slots[{k}]: count takes no column")
        else:
            if c is None or not 0 <= c < len(columns):
                raise ValueError(f"slots[{k}]: column {c} out of range")
            dt = columns[c].dtype
            if op in ("low", "high") and dt == torch.float64:
                raise TypeError(f"slots[{k}]: no limbs of a float64 column")
            if op in ("min", "max") and dt in (torch.bool, torch.uint8):
                raise TypeError(f"slots[{k}]: no {op} of a {dt} column")
        if valid is not None:
            same(f"slots[{k}].valid", valid)
            if valid.dtype != torch.bool:
                raise TypeError(f"slots[{k}].valid: dtype {valid.dtype} is "
                                f"not bool")


def _bits(v: torch.Tensor) -> torch.Tensor:
    """A 1-D accumulator column as its 8 raw bytes in int64."""
    return v.view(torch.int64) if v.dtype == torch.float64 \
        else v.to(torch.int64)


def _identity_bits(op: str, dtype: torch.dtype) -> int:
    """The 8 raw bytes, as an int64, of the value a slot holds for a group
    with no row: 0 for the sums and counts, the far end of the type's range
    for min and max."""
    if op not in ("min", "max"):
        return 0
    if dtype == torch.float64:
        return int(np.array(np.inf if op == "min" else -np.inf,
                            dtype=np.float64).view(np.int64))
    return int(_I64.max if op == "min" else _I64.min)


def dense_group_agg_plain(word, num_groups: int,
                          columns: Sequence[torch.Tensor],
                          slots: Sequence[Slot]) -> DenseAgg:
    """Plain-tensor version of ``dense_group_agg``: one masked pass per
    group and slot."""
    _check(word, num_groups, columns, slots)
    dev = word.device
    n = word.shape[0]
    G, K = num_groups, len(slots)
    dtypes = [_slot_dtype(op, None if c is None else columns[c])
              for op, c, _ in slots]
    w = word.to(torch.int64)
    io = torch.arange(n, dtype=torch.int64, device=dev)

    def full(v, dt=torch.int64):
        return torch.full((), v, dtype=dt, device=dev)

    counts, firsts = [], []
    cols: List[list] = [[] for _ in slots]
    for g in range(G):
        sel = w == g
        counts.append(torch.sum(sel).to(torch.int64))
        firsts.append(torch.min(torch.where(sel, io, n)) if n else full(n))
        for k, (op, c, valid) in enumerate(slots):
            m = sel if valid is None else (sel & valid)
            if op == "count":
                cols[k].append(torch.sum(m).to(torch.int64))
                continue
            x = columns[c]
            is_f = x.dtype == torch.float64
            if not is_f:
                x = x.to(torch.int64)
            if op in ("min", "max"):
                if is_f:
                    ident = full(np.inf if op == "min" else -np.inf,
                                 torch.float64)
                else:
                    ident = full(_I64.max if op == "min" else _I64.min)
                v = torch.where(m, x, ident)
                if n == 0:
                    cols[k].append(ident)
                else:
                    cols[k].append(torch.min(v) if op == "min"
                                   else torch.max(v))
                continue
            if op == "low":
                x = x & _LIMB_MASK
            elif op == "high":
                x = x >> 32
            cols[k].append(torch.sum(torch.where(m, x, torch.zeros(
                (), dtype=x.dtype, device=dev))))
    table = torch.stack([_bits(torch.stack(c)) for c in cols], dim=1) \
        if K else torch.zeros((G, 0), dtype=torch.int64, device=dev)
    return DenseAgg(torch.stack(counts), torch.stack(firsts), table, dtypes)


def _library():
    lib = _build.load("dense_group_agg")
    fn = lib.p1_dense_group_agg
    if fn.argtypes is None:
        p, i, i64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_int64
        pp, ip = ctypes.POINTER(ctypes.c_void_p), ctypes.POINTER(ctypes.c_int)
        fn.argtypes = [p, i, i64, i, i, pp, ip, i, ip, ip, ip, pp, i, p, p,
                       p, p, p]
        fn.restype = i
    return lib


def dense_group_agg(word, num_groups: int, columns: Sequence[torch.Tensor],
                    slots: Sequence[Slot]) -> DenseAgg:
    """Counts, first rows and one reduction per slot for each of
    ``num_groups`` (at most 256) groups; see the module docstring.

    ``word``: 1-D contiguous int32/int64.  ``columns``: at most 32 1-D
    contiguous int32 / int64 / float64 / bool tensors of ``word``'s length
    and device.  ``slots``: at most 64 ``(op, column index or None, valid or
    None)``."""
    global LAUNCHES
    columns = list(columns)
    slots = list(slots)
    _check(word, num_groups, columns, slots)
    if word.device.type == "cpu":
        return dense_group_agg_plain(word, num_groups, columns, slots)
    if word.device.type != "cuda":
        raise ValueError(f"unsupported device {word.device}")
    lib = _library()
    dev = word.device
    n = word.shape[0]
    G, K, V = num_groups, len(slots), len(columns)
    dtypes = [_slot_dtype(op, None if c is None else columns[c])
              for op, c, _ in slots]
    if n == 0:  # nothing to read: no launch, every group holds identities
        table = torch.empty((G, K), dtype=torch.int64, device=dev)
        for k, (op, _, _) in enumerate(slots):
            table[:, k] = _identity_bits(op, dtypes[k])
        return DenseAgg(torch.zeros((G,), dtype=torch.int64, device=dev),
                        torch.zeros((G,), dtype=torch.int64, device=dev),
                        table, dtypes)
    counts = torch.empty((G,), dtype=torch.int64, device=dev)
    first = torch.empty((G,), dtype=torch.int64, device=dev)
    table = torch.empty((G, K), dtype=torch.int64, device=dev)
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    blocks = max(1, min(-(-n // 2048), sms * 8))
    partials = torch.empty((blocks, G * (K + 2)), dtype=torch.int64,
                           device=dev)
    ptrs_v = (ctypes.c_void_p * max(V, 1))(*[c.data_ptr() for c in columns])
    types_v = (ctypes.c_int * max(V, 1))(*[_COL_CODES[c.dtype]
                                           for c in columns])
    ints = ctypes.c_int * max(K, 1)
    slot_col = ints(*[0 if c is None else c for _, c, _ in slots])
    slot_take = ints(*[_TAKE[op] for op, _, _ in slots])
    slot_red = ints(*[_REDUCE[op] for op, _, _ in slots])
    slot_valid = (ctypes.c_void_p * max(K, 1))(
        *[None if v is None else v.data_ptr() for _, _, v in slots])
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = lib.p1_dense_group_agg(
            word.data_ptr(), word.element_size(), n, G, V, ptrs_v, types_v,
            K, slot_col, slot_take, slot_red, slot_valid, blocks,
            partials.data_ptr(), counts.data_ptr(), first.data_ptr(),
            table.data_ptr(), stream)
    if err != 0:
        raise RuntimeError(
            f"dense_group_agg kernel launch failed: error {err} (n={n}, "
            f"groups={G}, columns={V}, slots={K}, blocks={blocks})")
    LAUNCHES += 1
    return DenseAgg(counts, first, table, dtypes)
