"""Clamped gathers: columns and rows at an index vector, and along an axis.

``gather_rows(sources, idx)`` is ``[s[clamp(idx, 0, n-1)] for s in sources]``
along axis 0 for tensors that share their first dimension: every source, 1-D
or ``[n, W]``, of any element width, moves in ONE launch (the index is read
once per row).  ``take_along_axis(x, idx, axis)`` is numpy's function of
that name on a 2-D ``x`` with clamped indices.

Replaces the gather probes of the JAX package: ``t1`` and ``t1b`` of
``experiments/pallas_primitives.py`` (``take`` of a vector, and of matrix
rows, in fast memory) and ``t1c`` / ``t1d`` of
``experiments/pallas_primitives2.py`` and ``experiments/pallas_primitives3.py``
(``take_along_axis`` on either axis).  Every payload move of the engine goes
through here (``batch.take_clamped`` / ``Column.gather`` /
``gather_columns``).  Clamping is part of the function:
``jnp.take(mode="clip")`` clamps and CUDA indexing does not.

Bound on an H100: memory.  The index is read and the output written once,
coalesced; the source is read wherever the index says, a 32-byte sector for
each element when the index is a random permutation, so a random gather is
bound by the card's random sector rate, which falls as the source outgrows
the L2.  ``csrc/gather.cu`` has two bodies: the row body (``gather_rows``:
``ROWS_PER_THREAD`` warp-interleaved rows a thread, the loads of a chunk of
columns in flight before any store, evict-last loads of the sources and
evict-first streams, column groups on ``blockIdx.y`` when the sources
exceed half the L2, tiles whose indices stay local moved whole by one group
in turn; the launch's shape is ``plan_gather``'s), the take body
(``take_along_axis``: ``TAKE_LOADS`` elements a thread from 16-byte index
vectors, every source load of a step in flight before any store, the row
index from a multiply-high by the width's magic number and none where the
width is 1, the row body's L2 policy; the launch's shape is
``plan_take``'s).

The ``*_plain`` functions are the same functions in plain tensor ops.  The
wrappers take them only for tensors that lie on the CPU; for CUDA tensors
they launch the kernel or raise.
"""

from __future__ import annotations

import ctypes
import itertools
import struct
from typing import List, NamedTuple, Sequence

import torch

from . import _build

# launches of the row body by ``gather_rows`` (and nothing else)
LAUNCHES = 0
# launches of the take body by ``take_along_axis`` (and nothing else)
TAKE_LAUNCHES = 0

# the geometry of csrc/gather.cu (checked against the library)
THREADS = 256
MAX_UNITS = 64      # word columns one launch of the row body takes
LOADS = 16          # source words a thread of the row body keeps in flight
ROWS_PER_THREAD = 4  # R: measured fastest at every element width
BLOCKS_PER_SM = 64  # blocks an SM, at most, in a one-group grid
# blocks an SM of each group when there are groups: fewer, so that a block
# probes several tiles at once, and enough that a group fills the card (4,
# 16 and 64 measured: 16 the best compromise over the main paths' calls)
GROUP_BLOCKS_PER_SM = 16
TAKE_LOADS = 8      # elements a thread of the take body has in flight

_IDX_DTYPES = (torch.int32, torch.int64)
_WIDTHS = (1, 2, 4, 8)
_LOG2 = {1: 0, 2: 1, 4: 2, 8: 3}


# Params of csrc/gather.cu, packed by struct (a few times cheaper than
# filling a ctypes structure field by field): idx, rows, n, count,
# per_group, keep, unused, then Unit[MAX_UNITS] (src, dst, lw, stride), the
# unused units zero; one format a unit count
_HEAD = "<Qqqiiii"
_UNIT = "QQii"
_PACK = {}


def _packer(count: int) -> struct.Struct:
    s = _PACK.get(count)
    if s is None:
        s = _PACK[count] = struct.Struct(
            _HEAD + _UNIT * count
            + f"{(MAX_UNITS - count) * struct.calcsize('<' + _UNIT)}x")
    return s


class GatherPlan(NamedTuple):
    wide: bool           # 64-bit source offsets
    blocks: int          # blockIdx.x extent (grid-stride beyond)
    groups: int          # blockIdx.y extent: groups of units
    per_group: int       # units a group takes
    keep: bool           # a group's sources fit the budget: evict-last


def plan_gather(rows: int, n: int, units: Sequence[tuple], sms: int,
                l2_bytes: int) -> GatherPlan:
    """The launch of the row body for ``rows`` output rows from ``n``
    source rows through ``units``, ``(word bytes, words a row)`` each.

    32-bit offsets where every source byte offset fits; groups of units on
    ``blockIdx.y`` when the sources (``n`` words of every unit) exceed the
    budget, half the L2, and there is more than one unit, each group's
    sources within the budget or one unit a group; the evict-last policy
    only where a group's sources fit the budget; a tile of
    ``ROWS_PER_THREAD`` rows a thread, at most ``BLOCKS_PER_SM`` blocks an
    SM, ``GROUP_BLOCKS_PER_SM`` a group with groups."""
    widest = max(w for w, _ in units)
    wide = n * max(w * k for w, k in units) > 2 ** 32
    budget = l2_bytes // 2
    source = n * sum(w for w, _ in units)
    per_group = len(units)
    if len(units) > 1 and source > budget:
        per_group = max(1, budget // (n * widest))
    groups = -(-len(units) // per_group)
    keep = (source if groups == 1 else n * per_group * widest) <= budget
    tiles = -(-rows // ROWS_PER_THREAD)
    per_sm = BLOCKS_PER_SM if groups == 1 else GROUP_BLOCKS_PER_SM
    blocks = max(1, min(-(-tiles // THREADS), sms * per_sm))
    return GatherPlan(wide, blocks, groups, per_group, keep)


# TakeParams of csrc/gather.cu: x, idx (16-byte boundary), out, total, n,
# wx, width, magic, shift, head, keep, vec_out
_TAKE = struct.Struct("<QQQqqqqqiiii")


class TakePlan(NamedTuple):
    wide: bool     # 64-bit offsets
    blocks: int    # the grid (grid-stride beyond)
    base: int      # the 16-byte boundary at or below the index's element 0
    head: int      # index elements between ``base`` and element 0
    vec_out: bool  # a vector store a step: head 0, output 16-byte aligned
    keep: bool     # x fits half the L2: evict-last source loads
    magic: int     # e // width by a multiply-high (``take_magic``)
    shift: int


def take_magic(width: int, bits: int) -> tuple:
    """``(magic, shift)`` with ``e // width == (t + ((e - t) >> 1)) >>
    shift``, ``t = (e * magic) >> bits``, for every ``0 <= e < 2**bits``
    (Granlund and Montgomery's division by an invariant integer; ``magic <
    2**bits``); ``(0, 0)`` for width 1, which divides nothing."""
    if width < 1:
        raise ValueError(f"width {width} < 1")
    if width == 1:
        return 0, 0
    log = (width - 1).bit_length()  # ceil(log2(width))
    return ((1 << bits) * ((1 << log) - width)) // width + 1, log - 1


def plan_take(total: int, width: int, x_numel: int, x_bytes: int,
              idx_bytes: int, idx_addr: int, out_addr: int, sms: int,
              occupancy, l2_bytes: int) -> TakePlan:
    """The launch of the take body for ``total`` index elements of
    ``idx_bytes`` at ``idx_addr`` (rows of ``width``) into an output at
    ``out_addr``, from an ``x`` of ``x_numel`` elements of ``x_bytes``.

    32-bit offsets where x's elements and the element numbers stay below
    2^31; the index read as 16-byte vectors from the boundary at or below
    its first element; evict-last source loads only where x fits half the
    L2 (the row body's budget); ``TAKE_LOADS`` elements a thread a step and
    at most ``occupancy(wide)`` blocks an SM (the kernel's occupancy, asked
    of the library), grid-stride beyond."""
    wide = x_numel >= 2 ** 31 or total >= 2 ** 31
    base = idx_addr - idx_addr % 16
    head = (idx_addr - base) // idx_bytes
    per = 16 // idx_bytes
    vectors = -(-(head + total) // per)
    per_block = THREADS * (TAKE_LOADS // per)
    blocks = max(1, min(-(-vectors // per_block), sms * occupancy(wide)))
    magic, shift = take_magic(width, 64 if wide else 32)
    return TakePlan(wide, blocks, base, head,
                    head == 0 and out_addr % 16 == 0,
                    x_numel * x_bytes <= l2_bytes // 2, magic, shift)


def _clamped(idx: torch.Tensor, n: int) -> torch.Tensor:
    return idx.to(torch.int64).clamp(0, n - 1)


def gather_rows_plain(sources: Sequence[torch.Tensor],
                      idx: torch.Tensor) -> List[torch.Tensor]:
    """Plain-tensor version of ``gather_rows``."""
    out = []
    for s in sources:
        n = s.shape[0]
        if n == 0:
            out.append(s.new_zeros((idx.shape[0],) + tuple(s.shape[1:])))
        else:
            out.append(s.index_select(0, _clamped(idx, n)))
    return out


def take_along_axis_plain(x: torch.Tensor, idx: torch.Tensor,
                          axis: int) -> torch.Tensor:
    """Plain-tensor version of ``take_along_axis``."""
    return torch.take_along_dim(x, _clamped(idx, x.shape[axis]), dim=axis)


_READY = None  # the library whose prototypes and geometry are set


def _library():
    """The loaded library (built first if need be), its prototypes set and
    its geometry checked against this module's once."""
    global _READY
    lib = _build.load("gather")
    if lib is _READY:
        return lib
    p, i, i64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_int64
    lib.p1_gather_rows.argtypes = [ctypes.c_char_p, i, i, i, i, p]
    lib.p1_gather_rows.restype = i
    lib.p1_take_along_axis.argtypes = [ctypes.c_char_p, i, i, i, i, i, p]
    lib.p1_take_along_axis.restype = i
    lib.p1_take_blocks_per_sm.argtypes = [i, i, i, i]
    lib.p1_take_blocks_per_sm.restype = i
    lib.p1_gather_geometry.argtypes = [ctypes.POINTER(i64)]
    lib.p1_gather_geometry.restype = None
    got = (i64 * 8)()
    lib.p1_gather_geometry(got)
    want = (THREADS, MAX_UNITS, LOADS, struct.calcsize("<" + _UNIT),
            _packer(1).size, ROWS_PER_THREAD, TAKE_LOADS, _TAKE.size)
    if tuple(got) != want:
        raise RuntimeError(f"csrc/gather.cu's geometry {tuple(got)} is not "
                           f"this module's {want}")
    _READY = lib
    return lib


def _check_idx(idx, dim: int):
    if not isinstance(idx, torch.Tensor):
        raise TypeError(f"idx: expected a tensor, got {type(idx)}")
    if idx.dtype not in _IDX_DTYPES:
        raise TypeError(f"idx: dtype {idx.dtype} is not int32/int64")
    if idx.dim() != dim:
        raise ValueError(f"idx: expected {dim}-D, got shape "
                         f"{tuple(idx.shape)}")


def _units(sources, outs) -> list:
    """``(src, dst, log2 word bytes, words a row)`` of every word column:
    a 1-D column is one unit of its element width; an ``[n, W]`` matrix one
    unit per word of its row, the widest word (at most 8 bytes) that
    divides the row and both addresses."""
    units = []
    for s, o in zip(sources, outs):
        w = s.element_size()
        if s.dim() == 1:
            units.append((s.data_ptr(), o.data_ptr(), _LOG2[w], 1))
            continue
        row = w * s.shape[1]
        sp, dp = s.data_ptr(), o.data_ptr()
        ww = next(x for x in (8, 4, 2, 1)
                  if row % x == 0 and sp % x == 0 and dp % x == 0)
        k = row // ww
        units.extend((sp + j * ww, dp + j * ww, _LOG2[ww], k)
                     for j in range(k))
    return units


def _gather(sources, outs, idx: torch.Tensor) -> None:
    """The row body for contiguous ``sources`` (``n >= 1`` rows) into
    ``outs`` (each ``[m, ...]`` like its source, on ``idx``'s device, at
    any address), ``m = len(idx) >= 1``: one launch a ``MAX_UNITS`` word
    columns."""
    global LAUNCHES
    lib = _library()
    dev = idx.device
    m, n = idx.shape[0], sources[0].shape[0]
    units = _units(sources, outs)
    sms, l2 = _build.sm_count(dev), _build.l2_bytes(dev)
    iw = idx.element_size()
    for at in range(0, len(units), MAX_UNITS):
        part = units[at:at + MAX_UNITS]
        plan = plan_gather(m, n, [(1 << lw, k) for _, _, lw, k in part],
                           sms, l2)
        params = _packer(len(part)).pack(
            idx.data_ptr(), m, n, len(part), plan.per_group, int(plan.keep),
            0, *itertools.chain.from_iterable(part))
        err = _build.launch_on(dev, lambda stream: lib.p1_gather_rows(
            params, iw, int(plan.wide), plan.blocks, plan.groups, stream))
        if err != 0:
            raise RuntimeError(
                f"gather kernel launch failed: error {err} (units="
                f"{len(part)}, rows={m}, n={n}, plan={plan})")
        LAUNCHES += 1


# blocks an SM of each take-body variant: (device, lt, index bytes, wide,
# axis) -> the occupancy the library reports
_TAKE_OCCUPANCY = {}


def _take_occupancy(lib, dev, key) -> int:
    got = _TAKE_OCCUPANCY.get((dev.index,) + key)
    if got is None:
        got = _build.launch_on(
            dev, lambda stream: lib.p1_take_blocks_per_sm(*key))
        if got < 1:
            raise RuntimeError(f"take_along_axis occupancy query failed: "
                               f"{got} (variant {key})")
        _TAKE_OCCUPANCY[(dev.index,) + key] = got
    return got


def _take(x: torch.Tensor, idx: torch.Tensor, axis: int,
          out: torch.Tensor) -> None:
    """One launch of the take body: contiguous ``x`` and ``idx`` (at least
    one element each, the gathered axis not empty) into ``out``."""
    global TAKE_LAUNCHES
    lib = _library()
    dev = x.device
    lt, iw = _LOG2[x.element_size()], idx.element_size()
    width = idx.shape[1]
    total = idx.numel()
    plan = plan_take(
        total, width, x.numel(), x.element_size(), iw, idx.data_ptr(),
        out.data_ptr(), _build.sm_count(dev),
        lambda wide: _take_occupancy(lib, dev, (lt, iw, int(wide), axis)),
        _build.l2_bytes(dev))
    magic = plan.magic - (1 << 64) if plan.magic >= 1 << 63 else plan.magic
    params = _TAKE.pack(x.data_ptr(), plan.base, out.data_ptr(), total,
                        x.shape[axis], x.shape[1], width, magic, plan.shift,
                        plan.head, int(plan.keep), int(plan.vec_out))
    err = _build.launch_on(dev, lambda stream: lib.p1_take_along_axis(
        params, lt, iw, int(plan.wide), axis, plan.blocks, stream))
    if err != 0:
        raise RuntimeError(
            f"take_along_axis kernel launch failed: error {err} (x="
            f"{tuple(x.shape)} {x.dtype}, idx={tuple(idx.shape)} "
            f"{idx.dtype}, axis={axis}, plan={plan})")
    TAKE_LAUNCHES += 1


def gather_rows(sources: Sequence[torch.Tensor],
                idx: torch.Tensor) -> List[torch.Tensor]:
    """``s[clamp(idx, 0, n-1)]`` along axis 0 for every ``s`` in ``sources``.

    ``sources``: contiguous 1-D or 2-D tensors with one first dimension ``n``
    on ``idx``'s device, elements of 1, 2, 4 or 8 bytes (any dtype: they are
    moved as words).  ``idx``: 1-D int32/int64.  An empty source gives zeros
    (there is no row to clamp to).  On a CUDA device one launch moves them
    all (one a ``MAX_UNITS`` word columns)."""
    sources = list(sources)
    _check_idx(idx, 1)
    dev = idx.device
    n = sources[0].shape[0] if sources else 0
    for k, s in enumerate(sources):
        if not isinstance(s, torch.Tensor):
            raise TypeError(f"sources[{k}]: expected a tensor")
        if s.device != dev:
            raise ValueError(f"sources[{k}] on {s.device}, idx on {dev}")
        if s.dim() not in (1, 2):
            raise ValueError(f"sources[{k}]: expected 1-D or 2-D, got shape "
                             f"{tuple(s.shape)}")
        if s.shape[0] != n:
            raise ValueError(f"sources[{k}]: {s.shape[0]} rows, sources[0] "
                             f"has {n}")
        if s.element_size() not in _WIDTHS:
            raise TypeError(f"sources[{k}]: dtype {s.dtype} is not 1, 2, 4 "
                            f"or 8 bytes wide")
        if not s.is_contiguous():
            raise ValueError(f"sources[{k}]: tensor is not contiguous")
    if dev.type == "cpu":
        return gather_rows_plain(sources, idx)
    if dev.type != "cuda":
        raise ValueError(f"unsupported device {dev}")
    if not sources:
        return []
    _library()
    m = idx.shape[0]
    idx = idx.contiguous()
    if n == 0:
        return [s.new_zeros((m,) + tuple(s.shape[1:])) for s in sources]
    outs = [s.new_empty((m,) + tuple(s.shape[1:])) for s in sources]
    # an [n, 0] matrix has nothing to move
    moved = [k for k, s in enumerate(sources) if s.dim() == 1 or s.shape[1]]
    if m and moved:
        _gather([sources[k] for k in moved], [outs[k] for k in moved], idx)
    return outs


def take_along_axis(x: torch.Tensor, idx: torch.Tensor,
                    axis: int) -> torch.Tensor:
    """``numpy.take_along_axis(x, clamp(idx), axis)`` for a contiguous 2-D
    ``x`` and a contiguous 2-D int32/int64 ``idx`` that matches ``x`` on the
    other axis.  On a CUDA device one launch of the take body."""
    if not isinstance(x, torch.Tensor) or x.dim() != 2:
        raise ValueError("x: expected a 2-D tensor")
    _check_idx(idx, 2)
    if axis not in (0, 1):
        raise ValueError(f"axis {axis} is not 0 or 1")
    other = 1 - axis
    if idx.shape[other] != x.shape[other]:
        raise ValueError(f"idx shape {tuple(idx.shape)} does not match x "
                         f"shape {tuple(x.shape)} off axis {axis}")
    if x.device != idx.device:
        raise ValueError(f"x on {x.device}, idx on {idx.device}")
    if x.element_size() not in _WIDTHS:
        raise TypeError(f"x: dtype {x.dtype} is not 1, 2, 4 or 8 bytes wide")
    if not x.is_contiguous() or not idx.is_contiguous():
        raise ValueError("x and idx must be contiguous")
    if x.device.type == "cpu":
        return take_along_axis_plain(x, idx, axis)
    if x.device.type != "cuda":
        raise ValueError(f"unsupported device {x.device}")
    _library()
    rows, width = idx.shape
    n = x.shape[axis]
    if n == 0:
        if rows * width:
            raise IndexError("take_along_axis over an empty axis")
        return x.new_zeros((rows, width))
    out = x.new_empty((rows, width))
    if rows * width:
        _take(x, idx, axis, out)
    return out
