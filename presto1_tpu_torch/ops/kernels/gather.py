"""Clamped gathers: columns and rows at an index vector, and along an axis.

``gather_rows(sources, idx)`` is ``[s[clamp(idx, 0, n-1)] for s in sources]``
along axis 0 for tensors that share their first dimension; 1-D columns of one
element width share one launch (the index is read once per row), an ``[n, W]``
matrix moves its rows whole.  ``take_along_axis(x, idx, axis)`` is numpy's
function of that name on a 2-D ``x`` with clamped indices.

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
each element when the index is a random permutation.  One CUDA body
(``csrc/gather.cu``) with five strides serves all four shapes.

The ``*_plain`` functions are the same functions in plain tensor ops.  The
wrappers take them only for tensors that lie on the CPU; for CUDA tensors
they launch the kernel or raise.
"""

from __future__ import annotations

import ctypes
from typing import List, Sequence

import torch

from . import _build

# launches of the CUDA kernel by this module's wrappers (and nothing else)
LAUNCHES = 0

_IDX_DTYPES = (torch.int32, torch.int64)
_WIDTHS = (1, 2, 4, 8)


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


def _library():
    lib = _build.load("gather")
    fn = lib.p1_gather
    if fn.argtypes is None:
        p, i, i64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_int64
        pp = ctypes.POINTER(ctypes.c_void_p)
        fn.argtypes = [pp, pp, i, i, p, i, i64, i64, i64,
                       ctypes.POINTER(i64), i, p]
        fn.restype = i
        for f in (lib.p1_gather_threads, lib.p1_gather_max_pairs):
            f.argtypes = []
            f.restype = i
    return lib


def _check_idx(idx, dim: int):
    if not isinstance(idx, torch.Tensor):
        raise TypeError(f"idx: expected a tensor, got {type(idx)}")
    if idx.dtype not in _IDX_DTYPES:
        raise TypeError(f"idx: dtype {idx.dtype} is not int32/int64")
    if idx.dim() != dim:
        raise ValueError(f"idx: expected {dim}-D, got shape "
                         f"{tuple(idx.shape)}")


def _launch(srcs, dsts, idx, rows: int, width: int, n: int, strides):
    """One launch: ``srcs`` / ``dsts`` are contiguous tensors of one element
    width on ``idx``'s device."""
    global LAUNCHES
    lib = _library()
    dev = idx.device
    count = len(srcs)
    threads = lib.p1_gather_threads()
    sms = _build.sm_count(dev)
    blocks = max(1, min(-(-(rows * width) // threads), sms * 16))
    ptrs = ctypes.c_void_p * count
    st = (ctypes.c_int64 * 5)(*strides)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = lib.p1_gather(
            ptrs(*[s.data_ptr() for s in srcs]),
            ptrs(*[d.data_ptr() for d in dsts]), count,
            srcs[0].element_size(), idx.data_ptr(), idx.element_size(),
            rows, width, n, st, blocks, stream)
    if err != 0:
        raise RuntimeError(
            f"gather kernel launch failed: error {err} (count={count}, "
            f"width={srcs[0].element_size()}, rows={rows}, n={n})")
    LAUNCHES += 1


def gather_rows(sources: Sequence[torch.Tensor],
                idx: torch.Tensor) -> List[torch.Tensor]:
    """``s[clamp(idx, 0, n-1)]`` along axis 0 for every ``s`` in ``sources``.

    ``sources``: contiguous 1-D or 2-D tensors with one first dimension ``n``
    on ``idx``'s device, elements of 1, 2, 4 or 8 bytes (any dtype: they are
    moved as words).  ``idx``: 1-D int32/int64.  An empty source gives zeros
    (there is no row to clamp to)."""
    sources = list(sources)
    _check_idx(idx, 1)
    for k, s in enumerate(sources):
        if not isinstance(s, torch.Tensor):
            raise TypeError(f"sources[{k}]: expected a tensor")
        if s.device != idx.device:
            raise ValueError(f"sources[{k}] on {s.device}, idx on "
                             f"{idx.device}")
        if s.dim() not in (1, 2):
            raise ValueError(f"sources[{k}]: expected 1-D or 2-D, got shape "
                             f"{tuple(s.shape)}")
        if s.shape[0] != sources[0].shape[0]:
            raise ValueError(f"sources[{k}]: {s.shape[0]} rows, sources[0] "
                             f"has {sources[0].shape[0]}")
        if s.element_size() not in _WIDTHS:
            raise TypeError(f"sources[{k}]: dtype {s.dtype} is not 1, 2, 4 "
                            f"or 8 bytes wide")
        if not s.is_contiguous():
            raise ValueError(f"sources[{k}]: tensor is not contiguous")
    if idx.device.type == "cpu":
        return gather_rows_plain(sources, idx)
    if idx.device.type != "cuda":
        raise ValueError(f"unsupported device {idx.device}")
    if not sources:
        return []
    max_pairs = _library().p1_gather_max_pairs()
    m = idx.shape[0]
    n = sources[0].shape[0]
    idx = idx.contiguous()
    make = torch.zeros if n == 0 else torch.empty
    outs = [make((m,) + tuple(s.shape[1:]), dtype=s.dtype, device=s.device)
            for s in sources]
    if n == 0 or m == 0:
        return outs
    # 1-D columns: one launch per element width (and per 32 columns)
    by_width: dict = {}
    for k, s in enumerate(sources):
        if s.dim() == 1:
            by_width.setdefault(s.element_size(), []).append(k)
    for ks in by_width.values():
        for at in range(0, len(ks), max_pairs):
            part = ks[at:at + max_pairs]
            _launch([sources[k] for k in part], [outs[k] for k in part],
                    idx, m, 1, n, (1, 0, 1, 0, 0))
    # [n, W] matrices: rows moved whole
    for k, s in enumerate(sources):
        if s.dim() == 2 and s.shape[1] > 0:
            w = s.shape[1]
            _launch([s], [outs[k]], idx, m, w, n, (1, 0, w, 0, 1))
    return outs


def take_along_axis(x: torch.Tensor, idx: torch.Tensor,
                    axis: int) -> torch.Tensor:
    """``numpy.take_along_axis(x, clamp(idx), axis)`` for a contiguous 2-D
    ``x`` and a contiguous 2-D int32/int64 ``idx`` that matches ``x`` on the
    other axis."""
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
    out = torch.empty((rows, width), dtype=x.dtype, device=x.device)
    if rows * width == 0:
        return out
    wx = x.shape[1]
    strides = (width, 1, wx, 0, 1) if axis == 0 else (width, 1, 1, wx, 0)
    _launch([x], [out], idx, rows, width, n, strides)
    return out
