"""Scatter to distinct targets, and stable compaction of a mask.

``scatter_distinct(idx, x, size, mask=None)`` returns a ``[size]`` tensor of
zeros with ``out[idx[i]] = x[i]`` for every row where ``mask`` holds (every
row without a mask); ``x=None`` scatters the row numbers themselves
(``x[i] = i`` as int64).  ``x`` may also be a list of up to ``MAX_COLUMNS``
columns sharing ``idx`` and ``mask``: one launch scatters all of them and
the result is a list.  Targets are distinct by contract; targets outside
``[0, size)`` are dropped.

``compact(mask, capacity)`` returns the stable indices of the true rows,
padded with 0 to ``capacity`` (the first ``capacity`` of them when more rows
are true), and their untruncated count as a 0-d int64 tensor on the mask's
device -- the engine's ``ops/segments.py::compact_indices`` and the JAX
package's ``presto1_tpu/ops/segments.py::compact_indices``.  No value
reaches the host.

Replaces the scatter probes of the JAX package, ``t2``
(``zeros.at[idx].set(x)``) and ``t8`` (a per-row scalar store loop) of
``experiments/pallas_primitives.py``.

Bound on an H100: memory.  The scatter reads the mask once, ``idx`` and
``x`` only where the mask holds, and writes the outputs once (zeroed by one
memset); the compaction reads the mask once and writes ``capacity`` words.
The CUDA kernels (``csrc/scatter.cu``) read the mask 16 bytes a lane, skip
a warp's all-false rows by ballot, and rank kept rows by popcount scans.
The compaction is ONE launch a call: a single pass with a decoupled
look-back that keeps a lane's mask words in registers from the load to the
writes.  Its state (a tile counter, the count and a flag a tile) is the
call's own: one zeroed allocation that also holds the count it returns, so
a CUDA graph that captures a call replays its zero-fill with it.

``scatter_distinct_plain`` and ``compact_plain`` are the same functions in
plain tensor ops.  The wrappers take them only for tensors that lie on the
CPU; for CUDA tensors they launch the kernels or raise.
"""

from __future__ import annotations

import ctypes
from typing import List, NamedTuple, Optional, Sequence, Tuple, Union

import torch

from . import _build

# launches of the scatter kernel by ``scatter_distinct`` (and nothing else)
LAUNCHES = 0
# calls of ``compact`` that launched its kernel (and nothing else)
COMPACT_LAUNCHES = 0

# the launch geometry of csrc/scatter.cu (checked against the library)
THREADS = 256
LANE_ROWS = 16                  # mask bytes a lane reads at once
WARP_ROWS = 32 * LANE_ROWS      # rows a warp step of the scatter covers
MAX_COLUMNS = 8                 # value columns one scatter launch takes
SPAN_WORDS = 4                  # mask words a lane of the look-back holds
STATE_WORDS = 2                 # state words ahead of the tile flags

_IDX_DTYPES = (torch.int32, torch.int64)
_X_DTYPES = (torch.int32, torch.int64, torch.float64)

Values = Union[None, torch.Tensor, Sequence[torch.Tensor]]


def scatter_plan(n: int, head: int, sms: int) -> int:
    """Blocks of one scatter launch over ``n`` rows whose mask starts
    ``head`` bytes past a 16-byte boundary: one warp step (512 rows) a warp
    at least, at most 8 blocks of 8 warps an SM (grid-stride beyond)."""
    steps = -(-(head + n) // WARP_ROWS)
    return max(1, min(-(-steps // (THREADS // 32)), sms * 8))


class CompactPlan(NamedTuple):
    blocks: int
    tiles: int   # tiles of THREADS * SPAN_WORDS words


def compact_route(n: int, head: int, sms: int, occupancy) -> CompactPlan:
    """The launch of ``compact`` over ``n >= 1`` rows whose mask starts
    ``head`` bytes past a 16-byte boundary; ``occupancy()`` is the blocks
    an SM the library reports for the look-back.  Tiles of ``THREADS *
    SPAN_WORDS`` words, one block a tile, at most the occupancy's blocks on
    every SM (they take further tiles in turn)."""
    words = -(-(head + n) // LANE_ROWS)
    tiles = -(-words // (THREADS * SPAN_WORDS))
    return CompactPlan(min(tiles, sms * occupancy()), tiles)


def _check_1d(name, t, n, device):
    if not isinstance(t, torch.Tensor) or t.dim() != 1 or t.shape[0] != n:
        raise ValueError(f"{name}: expected a 1-D tensor of length {n}")
    if t.device != device:
        raise ValueError(f"{name} on {t.device}, idx on {device}")
    if not t.is_contiguous():
        raise ValueError(f"{name}: tensor is not contiguous")


def _columns(x: Values, idx: torch.Tensor
             ) -> Tuple[List[torch.Tensor], bool]:
    """The value columns of a call (None: the row numbers as int64), and
    whether ``x`` was a list."""
    if x is None:
        return [torch.arange(idx.shape[0], dtype=torch.int64,
                             device=idx.device)], False
    if isinstance(x, torch.Tensor):
        return [x], False
    cols = list(x)
    if not cols or any(not isinstance(t, torch.Tensor) for t in cols):
        raise ValueError("x: expected None, a tensor or a non-empty list "
                         "of tensors")
    return cols, True


def _scatter_one_plain(idx, x, size, mask):
    t = idx.to(torch.int64)
    keep = (t >= 0) & (t < size)
    if mask is not None:
        keep = keep & mask
    # rows that are not kept land in a spare slot, dropped below
    out = torch.zeros((size + 1,), dtype=x.dtype, device=idx.device)
    out.scatter_(0, torch.where(keep, t, size), x)
    return out[:size]


def scatter_distinct_plain(idx: torch.Tensor, x: Values, size: int,
                           mask: Optional[torch.Tensor] = None):
    """Plain-tensor version of ``scatter_distinct``."""
    cols, many = _columns(x, idx)
    outs = [_scatter_one_plain(idx, c, size, mask) for c in cols]
    return outs if many else outs[0]


def compact_plain(mask: torch.Tensor, capacity: int):
    """Plain-tensor version of ``compact``: a prefix sum of the mask gives
    each true row its rank, and the row numbers scatter to their ranks."""
    count = torch.sum(mask)
    rank = torch.cumsum(mask, dim=0) - 1
    return scatter_distinct_plain(rank, None, capacity, mask), count


def _library():
    lib = _build.load("scatter")
    fn = lib.p1_scatter
    if fn.argtypes is None:
        p, i, i64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_int64
        pp, ip = ctypes.POINTER(ctypes.c_void_p), ctypes.POINTER(ctypes.c_int)
        fn.argtypes = [p, i, p, i64, i64, i64, i, pp, ip, pp, p, i64, i, p]
        fn.restype = i
        lib.p1_compact_one.argtypes = [p, i64, i64, i64, i, p, i64, p, p, p]
        lib.p1_compact_one.restype = i
        for name in ("p1_scatter_threads", "p1_scatter_max_columns",
                     "p1_compact_state_words", "p1_compact_span_words",
                     "p1_compact_blocks_per_sm"):
            getattr(lib, name).argtypes = []
            getattr(lib, name).restype = i
        got = (lib.p1_scatter_threads(), lib.p1_scatter_max_columns(),
               lib.p1_compact_state_words(), lib.p1_compact_span_words())
        if got != (THREADS, MAX_COLUMNS, STATE_WORDS, SPAN_WORDS):
            raise RuntimeError(f"csrc/scatter.cu's geometry {got} is not "
                               f"this module's")
    return lib


def _mask_base(mask: torch.Tensor) -> Tuple[int, int]:
    """(16-byte-aligned address at or below the mask's first byte, bytes
    between the two)."""
    ptr = mask.data_ptr()
    return ptr - ptr % 16, ptr % 16


def scatter_distinct(idx: torch.Tensor, x: Values, size: int,
                     mask: Optional[torch.Tensor] = None):
    """Zeros of ``[size]`` with ``out[idx[i]] = x[i]`` where ``mask[i]``.

    ``idx``: 1-D contiguous int32/int64.  ``x``: 1-D contiguous int32, int64
    or float64 of the same length, None for the row numbers as int64, or a
    list of at most ``MAX_COLUMNS`` such tensors (the result is then a list;
    one launch).  ``mask``: 1-D contiguous bool of the same length, or
    None.  Kept targets are distinct; targets outside ``[0, size)`` are
    dropped."""
    global LAUNCHES
    if not isinstance(idx, torch.Tensor) or idx.dim() != 1:
        raise ValueError("idx: expected a 1-D tensor")
    if idx.dtype not in _IDX_DTYPES:
        raise TypeError(f"idx: dtype {idx.dtype} is not int32/int64")
    if not idx.is_contiguous():
        raise ValueError("idx: tensor is not contiguous")
    n = idx.shape[0]
    cols, many = _columns(x, idx)
    if len(cols) > MAX_COLUMNS:
        raise ValueError(f"x: {len(cols)} columns, at most {MAX_COLUMNS}")
    for k, t in enumerate(cols):
        _check_1d("x" if not many else f"x[{k}]", t, n, idx.device)
        if t.dtype not in _X_DTYPES:
            raise TypeError(f"x: dtype {t.dtype} is not int32/int64/float64")
    if mask is not None:
        _check_1d("mask", mask, n, idx.device)
        if mask.dtype != torch.bool:
            raise TypeError(f"mask: dtype {mask.dtype} is not bool")
    if size < 0:
        raise ValueError(f"size {size} is negative")
    if idx.device.type == "cpu":
        return scatter_distinct_plain(idx, cols if many else cols[0], size,
                                      mask)
    if idx.device.type != "cuda":
        raise ValueError(f"unsupported device {idx.device}")
    lib = _library()
    dev = idx.device
    dtypes = [t.dtype for t in cols]
    if n == 0 or size == 0:  # nothing to write: no launch
        outs = [torch.zeros((size,), dtype=dt, device=dev) for dt in dtypes]
        return outs if many else outs[0]
    # the outputs of a launch share one buffer, zeroed by one memset
    widths = [torch.empty((), dtype=dt).element_size() for dt in dtypes]
    spans = [-(-size * w // 16) * 16 for w in widths]
    buf = torch.empty((sum(spans),), dtype=torch.uint8, device=dev)
    outs, at = [], 0
    for dt, w, span in zip(dtypes, widths, spans):
        outs.append(buf[at:at + size * w].view(dt))
        at += span
    base, head = _mask_base(mask) if mask is not None else (None, 0)
    blocks = scatter_plan(n, head, _build.sm_count(dev))
    k = len(cols)
    err = _build.launch_on(dev, lambda stream: lib.p1_scatter(
        idx.data_ptr(), idx.element_size(), base, head, n, size, k,
        (ctypes.c_void_p * k)(*[c.data_ptr() for c in cols]),
        (ctypes.c_int * k)(*widths),
        (ctypes.c_void_p * k)(*[o.data_ptr() for o in outs]),
        buf.data_ptr(), buf.numel(), blocks, stream))
    if err != 0:
        raise RuntimeError(f"scatter kernel launch failed: error {err} "
                           f"(n={n}, size={size}, columns={k})")
    LAUNCHES += 1
    return outs if many else outs[0]


# blocks an SM of the look-back: device index -> occupancy
_OCCUPANCY = {}


def _occupancy(lib, dev) -> int:
    got = _OCCUPANCY.get(dev.index)
    if got is None:
        got = _build.launch_on(
            dev, lambda stream: lib.p1_compact_blocks_per_sm())
        if got < 1:
            raise RuntimeError(f"compaction occupancy query failed: {got}")
        _OCCUPANCY[dev.index] = got
    return got


def compact(mask: torch.Tensor, capacity: int):
    """(indices[capacity] int64, count) of the true rows of ``mask``: the
    row numbers in order, padded with 0 (truncated to the first
    ``capacity`` when more rows are true); ``count`` the number of true
    rows, a 0-d int64 tensor on the mask's device.

    ``mask``: 1-D contiguous bool.  On a CUDA device one zero-fill of the
    call's state and one launch of the look-back."""
    global COMPACT_LAUNCHES
    if not isinstance(mask, torch.Tensor) or mask.dim() != 1:
        raise ValueError("mask: expected a 1-D tensor")
    if mask.dtype != torch.bool:
        raise TypeError(f"mask: dtype {mask.dtype} is not bool")
    if not mask.is_contiguous():
        raise ValueError("mask: tensor is not contiguous")
    if capacity < 0:
        raise ValueError(f"capacity {capacity} is negative")
    if mask.device.type == "cpu":
        return compact_plain(mask, capacity)
    if mask.device.type != "cuda":
        raise ValueError(f"unsupported device {mask.device}")
    lib = _library()
    dev = mask.device
    n = mask.shape[0]
    if n == 0:  # nothing to read: no launch
        return (mask.new_zeros((capacity,), dtype=torch.int64),
                mask.new_zeros((), dtype=torch.int64))
    base, head = _mask_base(mask)
    plan = compact_route(n, head, _build.sm_count(dev),
                         lambda: _occupancy(lib, dev))
    out = mask.new_empty((capacity,), dtype=torch.int64)
    # the count, then the look-back's state: zero before the launch, and
    # this call's alone for as long as its count is alive
    scratch = mask.new_zeros((1 + STATE_WORDS + plan.tiles,),
                             dtype=torch.int64)
    err = _build.launch_on(dev, lambda stream: lib.p1_compact_one(
        base, head, n, plan.tiles, plan.blocks, out.data_ptr(), capacity,
        scratch.data_ptr(), scratch[1:].data_ptr(), stream))
    if err != 0:
        raise RuntimeError(f"compaction kernel launch failed: error {err} "
                           f"(n={n}, capacity={capacity}, plan={plan})")
    COMPACT_LAUNCHES += 1
    return out, scratch[0]
