"""Segmented reductions over sorted group ids, and row compaction.

The reference builds every segmented reduction scatter-free because its
target serialises scatters, and keeps a simpler prefix-sum form for the CPU.
The prefix-sum form is the one ported: sums per segment are differences of
one full-length cumulative sum, which is deterministic for doubles (no float
atomics) and exact for integers.  Min/max per segment come from one extra
sort with the value as the trailing key.  Compaction is the compaction
kernel of ``kernels/scatter.py``.
"""

from __future__ import annotations

import numpy as np
import torch

from ..batch import take_clamped
from .common import searchsorted_fast, sort_multi
from .kernels.gather import gather_rows
from .kernels.scatter import compact


def segment_bounds(gid_sorted: torch.Tensor, num_segments: int):
    """(starts, ends) of each segment in the sorted gid array."""
    seg = torch.arange(num_segments, dtype=gid_sorted.dtype,
                       device=gid_sorted.device)
    starts = searchsorted_fast(gid_sorted, seg, side="left")
    ends = searchsorted_fast(gid_sorted, seg, side="right")
    return starts, ends


def sorted_segment_sum(vals_sorted: torch.Tensor, starts, ends
                       ) -> torch.Tensor:
    """Sum per segment (rows sorted by segment)."""
    ps = torch.cumsum(vals_sorted, dim=0)
    zero = torch.zeros((), dtype=ps.dtype, device=ps.device)
    end_v = torch.where(ends > 0, take_clamped(ps, ends - 1), zero)
    start_v = torch.where(starts > 0, take_clamped(ps, starts - 1), zero)
    return torch.where(ends > starts, end_v - start_v,
                       zero).to(vals_sorted.dtype)


def sorted_segment_sum_multi(vals_sorted, starts, ends) -> torch.Tensor:
    """Segmented sums for k columns at once -> [G, k].  ``vals_sorted`` is
    a sequence of k columns of one dtype and length.

    Each column is scanned on its own into a row of a [k, n + 1] prefix
    matrix (a cumulative sum along the outer dimension of an [n, k] matrix
    would run as one thread per column).  One gather launch then reads every
    column's prefix at the segment ends, and one at the starts."""
    cols = list(vals_sorted)
    n = cols[0].shape[0]
    # psz[j, i] = sum of the first i values of column j
    psz = torch.zeros((len(cols), n + 1), dtype=cols[0].dtype,
                      device=cols[0].device)
    for j, c in enumerate(cols):
        torch.cumsum(c, dim=0, out=psz[j, 1:])
    prefixes = list(psz.unbind(0))
    at_end = gather_rows(prefixes, ends.contiguous())
    at_start = gather_rows(prefixes, starts.contiguous())
    return torch.stack(at_end, dim=1) - torch.stack(at_start, dim=1)


def minmax_by_value_sort(key_words, vals: torch.Tensor, starts, ends,
                         is_min: bool, valid=None) -> torch.Tensor:
    """Min/max per segment via one extra sort with the value as the last
    key: ascending within each segment, so min = value at start and
    max = value at end-1.  ``vals`` are in ORIGINAL row order (same order
    as the key words).  Invalid rows get a sentinel that sorts away from
    the answer."""
    if vals.dtype.is_floating_point:
        sent = np.inf if is_min else -np.inf
    else:
        info = torch.iinfo(vals.dtype)
        sent = info.max if is_min else info.min
    v = vals if valid is None else torch.where(
        valid, vals, torch.full((), sent, dtype=vals.dtype,
                                device=vals.device))
    out = sort_multi(tuple(key_words) + (v,), num_keys=len(key_words) + 1)
    v_sorted = out[-1]
    return take_clamped(v_sorted, starts if is_min else ends - 1)


def compact_indices(mask: torch.Tensor, capacity: int):
    """Stable indices of True rows, padded with 0 to ``capacity`` (truncated
    to the first ``capacity`` when more rows are True).  Returns
    (indices[capacity] int64, count) with ``count`` the untruncated number of
    True rows, a 0-d tensor on the mask's device.

    The output shape is static, so this is the compaction kernel (counts
    per chunk of the mask, then ranks by popcount and writes): nothing
    reaches the host, where ``torch.nonzero`` would size its result on the
    host and stall the stream in the middle of a fragment."""
    return compact(mask.contiguous(), capacity)
