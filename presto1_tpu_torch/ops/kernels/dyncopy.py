"""Dynamic copy: the live prefix of each of k parts to its running offset.

``concat_rows(columns, counts, capacity)`` takes ``columns[c][p]``, part
``p``'s tensor for output column ``c``, and a device ``int64[k]`` of part
row counts.  It returns one ``[capacity, ...]`` tensor per column holding
part 0's first ``counts[0]`` rows, then part 1's first ``counts[1]`` rows,
and so on, each count clamped to ``[0, rows of its part]``; rows past the
total are zeros.  The counts stay on the device: nothing syncs with the
host.  A ``None`` entry stands for all-True rows of a bool column (a
validity mask that one part does not carry).  ``[n, W]`` entries of one
column may differ in ``W``: the narrower rows are padded with zeros to the
widest, as the JAX package's ``concat_batches`` pads them.

Replaces the dynamic-copy probes of the JAX package: ``t3``-``t6`` of
``experiments/pallas_primitives.py`` and ``t4a``, ``t4b/c``, ``t5b``,
``t6x``, ``t6p`` of ``experiments/pallas_primitives2.py`` (copies of a
dynamic size, to dynamic offsets, 1-D and 2-D, serial and pipelined).  The
engine's UNION ALL (``Executor._x_Union``) and FULL OUTER JOIN
(``batch.concat_batches``) are this function.

Bound on an H100: memory.  The live rows are read once and the
``capacity`` output rows written once.  One CUDA body
(``csrc/dyncopy.cu``): a table of up to 32 (source, capacity) pairs of one
row width, one launch per row width (and per 32 pairs).

``concat_rows_plain`` is the same function in plain tensor ops, written with
the JAX package's index arithmetic (iota, offsets, clamped take, ``where``).
The wrapper takes it only for tensors that lie on the CPU; for CUDA tensors
it launches the kernel or raises.
"""

from __future__ import annotations

import ctypes
import math
from typing import List, Optional, Sequence

import torch

from . import _build

# launches of the CUDA kernel by this module's wrapper (and nothing else)
LAUNCHES = 0

_WORDS = (16, 8, 4, 2, 1)
# every byte of a row a None entry stands for: True
_FILL = 1


def _out_shape(column, capacity: int):
    entries = [t for t in column if t is not None]
    rest = ()
    if entries[0].dim() == 2:
        rest = (max(t.shape[1] for t in entries),)
    return (capacity,) + rest, entries[0].dtype


def _part_rows(columns, k: int) -> List[int]:
    rows = []
    for p in range(k):
        sizes = {col[p].shape[0] for col in columns if col[p] is not None}
        if len(sizes) != 1:
            raise ValueError(f"part {p}: its tensors have row counts "
                             f"{sorted(sizes)}; expected one")
        rows.append(sizes.pop())
    return rows


def concat_rows_plain(columns: Sequence[Sequence[Optional[torch.Tensor]]],
                      counts: torch.Tensor, capacity: int
                      ) -> List[torch.Tensor]:
    """Plain-tensor version of ``concat_rows``."""
    columns = [list(c) for c in columns]
    k = counts.shape[0]
    # made on the device (no host-to-device copy), so a CUDA graph can
    # capture this version too
    caps = torch.stack([torch.full((), r, dtype=torch.int64,
                                   device=counts.device)
                        for r in _part_rows(columns, k)])
    cnt = torch.minimum(counts.clamp(min=0), caps)
    off = torch.cumsum(cnt, dim=0) - cnt
    i = torch.arange(capacity, dtype=torch.int64, device=counts.device)
    outs = []
    for column in columns:
        shape, dtype = _out_shape(column, capacity)
        out = torch.zeros(shape, dtype=dtype, device=counts.device)
        for p, src in enumerate(column):
            local = i - off[p]
            sel = (local >= 0) & (local < cnt[p])
            if src is None:
                g = torch.ones(shape, dtype=dtype, device=counts.device)
            elif src.shape[0] == 0:
                continue  # no row to take from; sel is all False
            else:
                if src.dim() == 2 and src.shape[1] < shape[1]:
                    src = torch.cat([src, src.new_zeros(
                        (src.shape[0], shape[1] - src.shape[1]))], dim=1)
                g = src.index_select(
                    0, local.clamp(0, src.shape[0] - 1))
            s = sel[:, None] if len(shape) == 2 else sel
            out = torch.where(s, g, out)
        outs.append(out)
    return outs


def _library():
    lib = _build.load("dyncopy")
    fn = lib.p1_dyncopy
    if fn.argtypes is None:
        p, i, i64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_int64
        pp = ctypes.POINTER(ctypes.c_void_p)
        pi64 = ctypes.POINTER(i64)
        fn.argtypes = [pp, pi64, pi64, i, i, pp, p, i64, i64, i, i, i, p]
        fn.restype = i
        for f in (lib.p1_dyncopy_threads, lib.p1_dyncopy_max_pairs):
            f.argtypes = []
            f.restype = i
    return lib


def _row_bytes(t: torch.Tensor) -> int:
    return t.element_size() * math.prod(t.shape[1:])


def _word(row_bytes: Sequence[int], ptrs: Sequence[int]) -> int:
    """The widest word that divides every row width and every address."""
    for w in _WORDS:
        if all(b % w == 0 for b in row_bytes) and \
                all(a % w == 0 for a in ptrs):
            return w
    return 1


def _launch(lib, group, outs, counts, caps, capacity: int) -> None:
    """One launch for the columns ``group`` (indices into ``outs``), whose
    output rows have one width in bytes."""
    global LAUNCHES
    k = len(caps)
    out_bytes = _row_bytes(outs[group[0]][1])
    srcs, row_bytes = [], []
    for c in group:
        for src in outs[c][0]:
            srcs.append(src)
            row_bytes.append(0 if src is None else _row_bytes(src))
    dsts = [outs[c][1] for c in group]
    ptrs = [0 if s is None else s.data_ptr() for s in srcs] + \
        [d.data_ptr() for d in dsts]
    w = _word(row_bytes + [out_bytes], ptrs)
    words = out_bytes // w
    dev = counts.device
    threads = lib.p1_dyncopy_threads()
    sms = _build.sm_count(dev)
    blocks = max(1, min(-(-(capacity * words) // threads), sms * 16))
    n = len(srcs)
    vp = ctypes.c_void_p
    i64 = ctypes.c_int64
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = lib.p1_dyncopy(
            (vp * n)(*[None if s is None else s.data_ptr() for s in srcs]),
            (i64 * n)(*[b // w for b in row_bytes]),
            (i64 * k)(*caps), k, len(group),
            (vp * len(dsts))(*[d.data_ptr() for d in dsts]),
            counts.data_ptr(), capacity, words, w, _FILL, blocks, stream)
    if err != 0:
        raise RuntimeError(
            f"dyncopy kernel launch failed: error {err} (k={k}, "
            f"cols={len(group)}, capacity={capacity}, word={w})")
    LAUNCHES += 1


def concat_rows(columns: Sequence[Sequence[Optional[torch.Tensor]]],
                counts: torch.Tensor, capacity: int) -> List[torch.Tensor]:
    """Per column, the first ``counts[p]`` rows of every part ``p`` one
    after the other in ``[capacity, ...]``, zeros past the total.

    ``columns``: a sequence of columns, each a sequence of k contiguous
    tensors (one per part, all of one dtype and of 1 or 2 dimensions; the
    tensors of one part share their row count) or ``None`` for all-True rows
    of a bool column.  ``counts``: contiguous int64 ``[k]`` on the tensors'
    device, 1 <= k <= 32."""
    columns = [list(c) for c in columns]
    if not isinstance(counts, torch.Tensor) or counts.dim() != 1 \
            or counts.dtype != torch.int64:
        raise TypeError("counts: expected a 1-D int64 tensor")
    if not counts.is_contiguous():
        raise ValueError("counts: tensor is not contiguous")
    k = counts.shape[0]
    if not 1 <= k <= 32:
        raise ValueError(f"{k} parts; 1 to 32 are taken")
    if capacity < 0:
        raise ValueError(f"capacity {capacity} is negative")
    for c, column in enumerate(columns):
        if len(column) != k:
            raise ValueError(f"column {c}: {len(column)} parts, counts has "
                             f"{k}")
        entries = [t for t in column if t is not None]
        if not entries:
            raise ValueError(f"column {c}: every part is None")
        for t in entries:
            if not isinstance(t, torch.Tensor):
                raise TypeError(f"column {c}: expected tensors")
            if t.device != counts.device:
                raise ValueError(f"column {c} on {t.device}, counts on "
                                 f"{counts.device}")
            if t.dtype != entries[0].dtype:
                raise TypeError(f"column {c}: dtypes {t.dtype} and "
                                f"{entries[0].dtype}")
            if t.element_size() not in (1, 2, 4, 8):
                raise TypeError(f"column {c}: dtype {t.dtype} is not 1, 2, "
                                f"4 or 8 bytes wide")
            if t.dim() != entries[0].dim() or t.dim() not in (1, 2):
                raise ValueError(f"column {c}: expected 1-D or 2-D tensors "
                                 f"of one rank")
            if not t.is_contiguous():
                raise ValueError(f"column {c}: tensor is not contiguous")
        if len(entries) < k and entries[0].dtype != torch.bool:
            raise TypeError(f"column {c}: None stands for all-True rows and "
                            f"is taken in bool columns only")
    rows = _part_rows(columns, k)
    if counts.device.type == "cpu":
        return concat_rows_plain(columns, counts, capacity)
    if counts.device.type != "cuda":
        raise ValueError(f"unsupported device {counts.device}")
    lib = _library()
    max_pairs = lib.p1_dyncopy_max_pairs()
    outs = []
    for column in columns:
        shape, dtype = _out_shape(column, capacity)
        outs.append((column, torch.empty(shape, dtype=dtype,
                                         device=counts.device)))
    result = [o for _, o in outs]
    if capacity == 0:
        return result
    # one launch per output row width (and per max_pairs // k columns)
    by_width: dict = {}
    for c, (_, out) in enumerate(outs):
        if out.numel() == 0:  # [capacity, 0]: nothing to write
            continue
        width = _row_bytes(out)
        by_width.setdefault(width, []).append(c)
    per_launch = max_pairs // k
    for cs in by_width.values():
        for at in range(0, len(cs), per_launch):
            _launch(lib, cs[at:at + per_launch], outs, counts, rows,
                    capacity)
    return result
