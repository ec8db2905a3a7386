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
``capacity`` output rows written once.  One CUDA body (``csrc/dyncopy.cu``)
and ONE launch a call, whatever the columns' element widths, nesting or
validity: a descriptor per column and a (source, row bytes) pair per column
and part in one parameter struct, 16-byte words whatever the element width,
shifted into place where a part's byte offset is not a multiple of 16
(``dyncopy_plan`` gives the tiles and the grid).

``concat_rows_plain`` is the same function in plain tensor ops, written with
the JAX package's index arithmetic (iota, offsets, clamped take, ``where``).
The wrapper takes it only for tensors that lie on the CPU; for CUDA tensors
it launches the kernel or raises.
"""

from __future__ import annotations

import ctypes
import struct
from typing import List, Optional, Sequence

import torch

from . import _build

# launches of the CUDA kernel by this module's wrapper (and nothing else)
LAUNCHES = 0

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


# the geometry of csrc/dyncopy.cu (checked against the library)
THREADS = 256
WORDS = 8                         # 16-byte words a thread moves a tile
TILE_BYTES = THREADS * WORDS * 16  # bytes of one column a tile covers
MAX_PARTS = 32
MAX_COLS = 48                     # columns one launch takes
MAX_PAIRS = 128                   # (column, part) pairs one launch takes
BLOCKS_PER_SM = 8

# Params of csrc/dyncopy.cu: counts, capacity, tiles, k, cols, fill, unused,
# cap[MAX_PARTS]; then Col[MAX_COLS] (dst, row_bytes, tile0, pair0, unused)
# and Pair[MAX_PAIRS] (src, row_bytes), each array at its fixed offset
_HEAD = f"<Qqqiiii{MAX_PARTS}q"
_COL = "Qqqii"
_PAIR = "Qq"
_PACK = {}


def _packer(cols: int, pairs: int) -> struct.Struct:
    """The struct of a launch of ``cols`` columns and ``pairs`` pairs, the
    unused entries zero."""
    s = _PACK.get((cols, pairs))
    if s is None:
        col_size, pair_size = (struct.calcsize("<" + f)
                               for f in (_COL, _PAIR))
        s = _PACK[(cols, pairs)] = struct.Struct(
            _HEAD + _COL * cols + f"{(MAX_COLS - cols) * col_size}x"
            + _PAIR * pairs + f"{(MAX_PAIRS - pairs) * pair_size}x")
    return s


def dyncopy_plan(col_bytes: Sequence[int], sms: int) -> tuple:
    """(tile0 of each column, tiles, blocks) of one launch over columns of
    ``col_bytes`` output bytes each: a column's tiles cover its 16-byte
    words, ``TILE_BYTES`` a tile; a grid of at most ``BLOCKS_PER_SM``
    blocks an SM strides over all of them."""
    tile0, tiles = [], 0
    for b in col_bytes:
        tile0.append(tiles)
        tiles += -(-b // TILE_BYTES)
    return tile0, tiles, max(1, min(tiles, sms * BLOCKS_PER_SM))


_READY = None  # the library whose prototypes and geometry are set


def _library():
    """The loaded library (built first if need be), its prototypes set and
    its geometry checked against this module's once."""
    global _READY
    lib = _build.load("dyncopy")
    if lib is _READY:
        return lib
    i, i64 = ctypes.c_int, ctypes.c_int64
    lib.p1_dyncopy.argtypes = [ctypes.c_char_p, i, ctypes.c_void_p]
    lib.p1_dyncopy.restype = i
    lib.p1_dyncopy_geometry.argtypes = [ctypes.POINTER(i64)]
    lib.p1_dyncopy_geometry.restype = None
    got = (i64 * 8)()
    lib.p1_dyncopy_geometry(got)
    want = (THREADS, WORDS, MAX_PARTS, MAX_COLS, MAX_PAIRS,
            struct.calcsize("<" + _PAIR), struct.calcsize("<" + _COL),
            _packer(1, 1).size)
    if tuple(got) != want:
        raise RuntimeError(f"csrc/dyncopy.cu's geometry {tuple(got)} is "
                           f"not this module's {want}")
    _READY = lib
    return lib


def _launch(lib, group, counts, caps, capacity: int) -> None:
    """One launch for ``group``: ``(out, [(source pointer or 0, source row
    bytes) per part])`` of each column."""
    global LAUNCHES
    k = len(caps)
    dev = counts.device
    col_bytes = [o.numel() * o.element_size() for o, _ in group]
    tile0, tiles, blocks = dyncopy_plan(col_bytes, _build.sm_count(dev))
    cols, pairs = [], []
    for c, (o, entries) in enumerate(group):
        cols.extend((o.data_ptr(), col_bytes[c] // capacity, tile0[c],
                     c * k, 0))
        for ptr_bytes in entries:
            pairs.extend(ptr_bytes)
    params = _packer(len(group), len(group) * k).pack(
        counts.data_ptr(), capacity, tiles, k, len(group), _FILL, 0,
        *caps, *([0] * (MAX_PARTS - k)), *cols, *pairs)
    err = _build.launch_on(
        dev, lambda stream: lib.p1_dyncopy(params, blocks, stream))
    if err != 0:
        raise RuntimeError(
            f"dyncopy kernel launch failed: error {err} (k={k}, "
            f"cols={len(group)}, capacity={capacity}, tiles={tiles})")
    LAUNCHES += 1


def concat_rows(columns: Sequence[Sequence[Optional[torch.Tensor]]],
                counts: torch.Tensor, capacity: int) -> List[torch.Tensor]:
    """Per column, the first ``counts[p]`` rows of every part ``p`` one
    after the other in ``[capacity, ...]``, zeros past the total.

    ``columns``: a sequence of columns, each a sequence of k contiguous
    tensors (one per part, all of one dtype and of 1 or 2 dimensions; the
    tensors of one part share their row count) or ``None`` for all-True rows
    of a bool column.  ``counts``: contiguous int64 ``[k]`` on the tensors'
    device, 1 <= k <= 32.  On a CUDA device one launch moves every column
    (one a ``MAX_COLS`` columns or ``MAX_PAIRS`` pairs)."""
    columns = [list(c) for c in columns]
    if not isinstance(counts, torch.Tensor) or counts.dim() != 1 \
            or counts.dtype != torch.int64:
        raise TypeError("counts: expected a 1-D int64 tensor")
    if not counts.is_contiguous():
        raise ValueError("counts: tensor is not contiguous")
    k = counts.shape[0]
    if not 1 <= k <= MAX_PARTS:
        raise ValueError(f"{k} parts; 1 to {MAX_PARTS} are taken")
    if capacity < 0:
        raise ValueError(f"capacity {capacity} is negative")
    dev = counts.device
    # one pass: the checks, the parts' row counts, each column's output
    # shape and its (pointer, row bytes) pairs
    rows = [None] * k
    described = []
    for c, column in enumerate(columns):
        if len(column) != k:
            raise ValueError(f"column {c}: {len(column)} parts, counts has "
                             f"{k}")
        first, width, pairs, fills = None, 0, [], False
        for p, t in enumerate(column):
            if t is None:  # all-True rows: a null source of fill bytes
                pairs.append((0, 0))
                fills = True
                continue
            if not isinstance(t, torch.Tensor):
                raise TypeError(f"column {c}: expected tensors")
            # each attribute read once: this loop is the call's host cost
            dim, size, shape = t.dim(), t.element_size(), t.shape
            if first is None:
                first, dtype, rank = t, t.dtype, dim
            if t.device != dev:
                raise ValueError(f"column {c} on {t.device}, counts on "
                                 f"{dev}")
            if t.dtype != dtype:
                raise TypeError(f"column {c}: dtypes {t.dtype} and {dtype}")
            if size not in (1, 2, 4, 8):
                raise TypeError(f"column {c}: dtype {t.dtype} is not 1, 2, "
                                f"4 or 8 bytes wide")
            if dim != rank or dim not in (1, 2):
                raise ValueError(f"column {c}: expected 1-D or 2-D tensors "
                                 f"of one rank")
            if not t.is_contiguous():
                raise ValueError(f"column {c}: tensor is not contiguous")
            n = shape[0]
            if rows[p] is None:
                rows[p] = n
            elif rows[p] != n:
                raise ValueError(f"part {p}: its tensors have row counts "
                                 f"{sorted({rows[p], n})}; expected one")
            if dim == 2:
                width = max(width, shape[1])
                size *= shape[1]
            pairs.append((t.data_ptr(), size))
        if first is None:
            raise ValueError(f"column {c}: every part is None")
        # (not `None in column`: that compares every tensor with None)
        if fills and dtype != torch.bool:
            raise TypeError(f"column {c}: None stands for all-True rows and "
                            f"is taken in bool columns only")
        described.append((first, width if rank == 2 else None, pairs))
    if None in rows:
        raise ValueError(f"part {rows.index(None)}: every column is None")
    if dev.type == "cpu":
        return concat_rows_plain(columns, counts, capacity)
    if dev.type != "cuda":
        raise ValueError(f"unsupported device {dev}")
    lib = _library()
    outs, moved = [], []
    for first, width, pairs in described:
        out = first.new_empty((capacity,) if width is None
                              else (capacity, width))
        outs.append(out)
        if out.numel():  # [capacity, 0] or capacity 0: nothing to write
            moved.append((out, pairs))
    per_launch = min(MAX_COLS, MAX_PAIRS // k)
    for at in range(0, len(moved), per_launch):
        _launch(lib, moved[at:at + per_launch], counts, rows, capacity)
    return outs
