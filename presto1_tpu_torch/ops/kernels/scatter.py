"""Scatter to distinct targets: ``out[idx[i]] = x[i]`` over a zeroed output.

``scatter_distinct(idx, x, size, mask=None)`` returns a ``[size]`` tensor of
zeros with ``out[idx[i]] = x[i]`` for every row where ``mask`` holds (every
row without a mask); ``x=None`` scatters the row numbers themselves
(``x[i] = i`` as int64, generated in the kernel).  Targets are distinct by contract;
targets outside ``[0, size)`` are dropped.

Replaces the scatter probes of the JAX package, ``t2``
(``zeros.at[idx].set(x)``) and ``t8`` (a per-row scalar store loop) of
``experiments/pallas_primitives.py``.  The engine's stable compaction
(``ops/segments.py::compact_indices``: prefix sum of the mask, then each kept
row's number written to its rank) is this function with ``x=None``.

Bound on an H100: memory.  ``mask`` is read once, ``idx`` and ``x`` only
where the mask holds (all of them without a mask), coalesced; each kept row
writes 4 or 8 bytes where ``idx`` says.  A
compaction's targets ascend, so its writes coalesce; a random permutation
pays a 32-byte sector a row.  The CUDA kernel (``csrc/scatter.cu``) is one
thread a row under a grid-stride loop.

``scatter_distinct_plain`` is the same function in plain tensor ops.  The
wrapper takes it only for tensors that lie on the CPU; for CUDA tensors it
launches the kernel or raises.
"""

from __future__ import annotations

import ctypes
from typing import Optional

import torch

from . import _build

# launches of the CUDA kernel by this module's wrapper (and nothing else)
LAUNCHES = 0

_IDX_DTYPES = (torch.int32, torch.int64)
_X_DTYPES = (torch.int32, torch.int64, torch.float64)


def scatter_distinct_plain(idx: torch.Tensor, x: Optional[torch.Tensor],
                           size: int, mask: Optional[torch.Tensor] = None
                           ) -> torch.Tensor:
    """Plain-tensor version of ``scatter_distinct``."""
    n = idx.shape[0]
    if x is None:
        x = torch.arange(n, dtype=torch.int64, device=idx.device)
    t = idx.to(torch.int64)
    keep = (t >= 0) & (t < size)
    if mask is not None:
        keep = keep & mask
    # rows that are not kept land in a spare slot, dropped below
    out = torch.zeros((size + 1,), dtype=x.dtype, device=idx.device)
    out.scatter_(0, torch.where(keep, t, size), x)
    return out[:size]


def _library():
    lib = _build.load("scatter")
    fn = lib.p1_scatter
    if fn.argtypes is None:
        p, i, i64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_int64
        fn.argtypes = [p, i, p, p, p, i, i64, i64, i, p]
        fn.restype = i
        lib.p1_scatter_threads.argtypes = []
        lib.p1_scatter_threads.restype = i
    return lib


def scatter_distinct(idx: torch.Tensor, x: Optional[torch.Tensor], size: int,
                     mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Zeros of ``[size]`` with ``out[idx[i]] = x[i]`` where ``mask[i]``.

    ``idx``: 1-D contiguous int32/int64.  ``x``: 1-D contiguous int32, int64
    or float64 of the same length, or None for the row numbers as int64.
    ``mask``: 1-D contiguous bool of the same length, or None.  Kept targets are distinct; targets outside ``[0, size)`` are
    dropped."""
    global LAUNCHES
    if not isinstance(idx, torch.Tensor) or idx.dim() != 1:
        raise ValueError("idx: expected a 1-D tensor")
    if idx.dtype not in _IDX_DTYPES:
        raise TypeError(f"idx: dtype {idx.dtype} is not int32/int64")
    n = idx.shape[0]
    others = {"x": x, "mask": mask}
    for name, t in others.items():
        if t is None:
            continue
        if not isinstance(t, torch.Tensor) or t.dim() != 1 \
                or t.shape[0] != n:
            raise ValueError(f"{name}: expected a 1-D tensor of length {n}")
        if t.device != idx.device:
            raise ValueError(f"{name} on {t.device}, idx on {idx.device}")
        if not t.is_contiguous():
            raise ValueError(f"{name}: tensor is not contiguous")
    if not idx.is_contiguous():
        raise ValueError("idx: tensor is not contiguous")
    if x is not None and x.dtype not in _X_DTYPES:
        raise TypeError(f"x: dtype {x.dtype} is not int32/int64/float64")
    if mask is not None and mask.dtype != torch.bool:
        raise TypeError(f"mask: dtype {mask.dtype} is not bool")
    if size < 0:
        raise ValueError(f"size {size} is negative")
    if idx.device.type == "cpu":
        return scatter_distinct_plain(idx, x, size, mask)
    if idx.device.type != "cuda":
        raise ValueError(f"unsupported device {idx.device}")
    lib = _library()
    dev = idx.device
    out = torch.zeros((size,), dtype=torch.int64 if x is None else x.dtype,
                      device=dev)
    if n == 0 or size == 0:  # nothing to write: no launch
        return out
    threads = lib.p1_scatter_threads()
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    blocks = max(1, min(-(-n // threads), sms * 16))
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = lib.p1_scatter(
            idx.data_ptr(), idx.element_size(),
            None if x is None else x.data_ptr(),
            None if mask is None else mask.data_ptr(),
            out.data_ptr(), out.element_size(), n, size, blocks, stream)
    if err != 0:
        raise RuntimeError(f"scatter kernel launch failed: error {err} "
                           f"(n={n}, size={size})")
    LAUNCHES += 1
    return out
