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
(``csrc/dense_group_agg.cu``) takes one of three paths, picked by
``plan_dense`` from the recipe and the shared-memory budget:

* ``int`` -- a recipe of integers only (TPC-H Q1's): lanes own pairs of
  rows, each column's pair copied once into shared memory by one 16-byte
  ``cp.async`` (8 bytes for int32; two copies where a view starts off that
  alignment); every thread folds into a private table in shared memory
  without atomics (integer add, min and max are exact in any order), both
  rows of a pair in one branch-free batch;
* ``hist`` -- no slot: counts with 32-bit shared atomics, the word read 16
  bytes a lane;
* ``general`` -- anything else (float64 slots): lanes own slots, each cell
  has one owner and sees its rows in order, so float64 sums are the same
  from run to run (they differ from the plain version's by summation order
  only).

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

# the layout constants of csrc/dense_group_agg.cu (checked against the
# library): shared memory a block may use, the general path's budget and most
# threads, the int path's distinct columns, stages and plain slots held in
# registers, the histogram's threads (the most its kernel takes)
BLOCK_SHARED = 232_448
GENERAL_SHARED = 200 * 1024
GENERAL_MAX_THREADS = 256
INT_COLUMNS = 6
INT_STAGES = 2
INT_PLAIN = 16
HIST_THREADS = 256
# the plan's own choices
SM_SHARED = 233_472       # an SM's, of which each resident block costs 1 KB
INT_MIN_THREADS = 64      # fewer threads a block than this: general path
PATHS = {"general": 0, "int": 1, "hist": 2}

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


@dataclass(frozen=True)
class DensePlan:
    """How one call runs: the path, threads and blocks of its main kernel,
    and the shared memory a block of it takes.  The kernel launches with
    these and refuses a plan whose shared bytes are not its layout's."""

    path: str
    threads: int
    blocks: int
    shared: int


def _general_shared(groups: int, k: int) -> Tuple[int, int]:
    """(warps, bytes) of the general path's block: as many warps (at most
    8) as hold ``copies`` tables of ``groups x (k + 2)`` cells in 200 KB
    (csrc's ``general_shared``)."""
    sub = 32
    if 1 <= k <= 16:
        sub = 1 << max(k - 1, 0).bit_length()
    info = -(-k * 32 // 8) * 8  # SlotInfo: two pointers and three ints
    per_warp = (32 // sub) * groups * (k + 2) * 8
    warps = min(GENERAL_MAX_THREADS // 32,
                (GENERAL_SHARED - info) // per_warp)
    return warps, info + warps * per_warp


def plan_dense(n: int, num_groups: int,
               column_dtypes: Sequence[torch.dtype], slots: Sequence[tuple],
               sms: int, path: Optional[str] = None) -> DensePlan:
    """The launch plan of ``dense_group_agg`` over ``n`` rows (n >= 1).
    ``slots`` are ``(op, column index or None, validity)`` where validity
    is None or anything that tells validity columns apart (the wrapper
    passes their addresses); ``sms`` is the device's SMs.  ``path`` forces a
    path (to hold one against another); by default:

    * no slot: ``hist`` (rows counted in 32 bits: n < 2^32 - 1);
    * no float64 column, at most ``INT_COLUMNS`` distinct value and
      validity columns, and a private table (and a row of values) for
      ``INT_MIN_THREADS`` threads or more in ``BLOCK_SHARED``: ``int``;
    * anything else: ``general``."""
    k = len(slots)
    used = {c for _, c, _ in slots if c is not None}
    reads = len(used) + len({v for _, _, v in slots if v is not None})

    # plain slots add a value column without validity; the int path keeps a
    # scratch row of values a thread unless every slot is plain
    plain = sum(1 for op, c, v in slots if op in ("sum", "low", "high")
                and v is None and column_dtypes[c] not in (torch.bool,
                                                           torch.uint8))
    scratch = plain < k or plain > INT_PLAIN

    def int_shared(threads, scratch):
        # a table and a scratch row a thread, INT_STAGES slots of 16 bytes a
        # column and the word a thread (csrc's int_shared)
        words = threads * num_groups * (k + 2) \
            + (threads * INT_COLUMNS if scratch else 0)
        return -(-words // 2) * 16 + threads * INT_STAGES * (reads + 1) * 16

    def int_threads():
        # a multiple of 16 keeps the cell-major tables free of conflicts
        threads = 256
        while threads > 32 and \
                int_shared(threads, scratch) > BLOCK_SHARED:
            threads -= 16
        return threads
    integers = k > 0 and reads <= INT_COLUMNS and all(
        column_dtypes[c] != torch.float64 for c in used)
    if path is None:
        if k == 0:
            path = "hist" if n < (1 << 32) - 1 else "general"
        elif integers and int_threads() >= INT_MIN_THREADS \
                and int_shared(INT_MIN_THREADS, scratch) <= BLOCK_SHARED:
            path = "int"
        else:
            path = "general"
    elif path == "int" and not integers \
            or path == "hist" and (k or n >= (1 << 32) - 1):
        raise ValueError(f"the recipe does not take the {path} path")
    if path == "hist":
        return DensePlan("hist", HIST_THREADS,
                         max(1, min(-(-n // (HIST_THREADS * 16)), sms * 8)),
                         (HIST_THREADS // 32 + 1) * num_groups * 4)
    if path == "int":
        threads = int_threads()
        shared = int_shared(threads, scratch)
        if shared > BLOCK_SHARED:
            raise ValueError(f"{num_groups} groups x {k} slots do not fit "
                             f"the {path} path")
        per_sm = max(1, min(2048 // threads, SM_SHARED // (shared + 1024)))
        blocks = max(1, min(-(-n // (threads * 16)), sms * per_sm))
        return DensePlan(path, threads, blocks, shared)
    warps, shared = _general_shared(num_groups, k)
    return DensePlan("general", warps * 32,
                     max(1, min(-(-n // 2048), sms * 8)), shared)


def _library():
    lib = _build.load("dense_group_agg")
    fn = lib.p1_dense_group_agg
    if fn.argtypes is None:
        p, i, i64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_int64
        pp, ip = ctypes.POINTER(ctypes.c_void_p), ctypes.POINTER(ctypes.c_int)
        lib.p1_dense_geometry.argtypes = [ip]
        lib.p1_dense_geometry.restype = None
        got = (ctypes.c_int * 7)()
        lib.p1_dense_geometry(got)
        want = (BLOCK_SHARED, GENERAL_SHARED, GENERAL_MAX_THREADS,
                INT_COLUMNS, INT_STAGES, INT_PLAIN, HIST_THREADS)
        if tuple(got) != want:
            raise RuntimeError(f"csrc/dense_group_agg.cu's geometry "
                               f"{tuple(got)} is not this module's {want}")
        fn.argtypes = [p, i, i64, i, i, pp, ip, i, ip, ip, ip, pp, i, i, i64,
                       i, p, p, p, p, p]
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
    return _dense_group_agg(word, num_groups, columns, slots)


def _dense_group_agg(word, num_groups, columns, slots,
                     path: Optional[str] = None) -> DenseAgg:
    """``dense_group_agg``; ``path`` forces a path of ``plan_dense``."""
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
    plan = plan_dense(
        n, G, [c.dtype for c in columns],
        [(op, c, None if v is None else v.data_ptr()) for op, c, v in slots],
        _build.sm_count(dev), path)
    # one allocation: counts, first rows, the table, the blocks' partials
    GS = G * (K + 2)
    buf = torch.empty((GS + plan.blocks * GS,), dtype=torch.int64,
                      device=dev)
    counts, first = buf[:G], buf[G:2 * G]
    table = buf[2 * G:GS].view(G, K)
    ptrs_v = (ctypes.c_void_p * max(V, 1))(*[c.data_ptr() for c in columns])
    types_v = (ctypes.c_int * max(V, 1))(*[_COL_CODES[c.dtype]
                                           for c in columns])
    ints = ctypes.c_int * max(K, 1)
    slot_col = ints(*[0 if c is None else c for _, c, _ in slots])
    slot_take = ints(*[_TAKE[op] for op, _, _ in slots])
    slot_red = ints(*[_REDUCE[op] for op, _, _ in slots])
    slot_valid = (ctypes.c_void_p * max(K, 1))(
        *[None if v is None else v.data_ptr() for _, _, v in slots])
    err = _build.launch_on(dev, lambda stream: lib.p1_dense_group_agg(
        word.data_ptr(), word.element_size(), n, G, V, ptrs_v, types_v,
        K, slot_col, slot_take, slot_red, slot_valid, PATHS[plan.path],
        plan.threads, plan.shared, plan.blocks, buf[GS:].data_ptr(),
        counts.data_ptr(), first.data_ptr(), table.data_ptr(), stream))
    if err != 0:
        raise RuntimeError(
            f"dense_group_agg kernel launch failed: error {err} (n={n}, "
            f"groups={G}, columns={V}, slots={K}, plan={plan})")
    LAUNCHES += 1
    return DenseAgg(counts, first, table, dtypes)
