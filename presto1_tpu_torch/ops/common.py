"""Shared operator utilities: key packing, multi-operand sort and row-index
helpers.

Replaces the reference's compiled hash strategies (``sql/gen/JoinCompiler``,
``operator/GroupByHash``'s per-type fast paths): instead of per-row hashing
of multi-channel keys, the normalised key columns are bit-packed into one
int64 word (TPC-H composite keys fit comfortably), so grouping and join
matching become integer sort/search problems.

Two remedies of the JAX package for its TPU compiler are not carried over:
``_wide_sort_rows`` (a row threshold that moved wide variadic sorts to a
permutation + gather form) and ``searchsorted_cosort`` (a scatter-free
searchsorted by co-sorting).  Here every sort is a permutation + gather
(``sort_multi``) and ``searchsorted_fast`` is ``torch.searchsorted``.
"""

from __future__ import annotations

from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch

from ..batch import Column
from .kernels.gather import gather_rows

INT64_MAX = np.iinfo(np.int64).max


def key_ranges(cols: Sequence[Column], num_rows) -> List[Tuple[int, int]]:
    """Host-synced (min, max) per key column over the first num_rows rows.

    Used by the eager executor only; compiled fragments take static ranges
    recorded during discovery and never call this.
    """
    out = []
    for c in cols:
        n = len(c)
        live = iota(n, c.data.device) < num_rows
        if c.validity is not None:
            live = live & c.validity
        data = c.data.to(torch.int64)
        if n == 0:
            out.append((0, 0))
            continue
        lo = torch.min(torch.where(live, data, INT64_MAX))
        hi = torch.max(torch.where(live, data, -INT64_MAX))
        lo_i, hi_i = (int(v) for v in torch.stack([lo, hi]).tolist())
        if lo_i > hi_i:  # all-null / empty
            lo_i, hi_i = 0, 0
        out.append((lo_i, hi_i))
    return out


def _dead_rows(n: int, num_rows, mask, device) -> torch.Tensor:
    dead = iota(n, device) >= num_rows
    if mask is not None:
        dead = dead | ~mask
    return dead


def pack_key_words(
    cols: Sequence[Column],
    ranges: Sequence[Tuple[int, int]],
    num_rows,
    mask: Optional[torch.Tensor] = None,
    null_high: bool = False,
) -> List[torch.Tensor]:
    """Bit-pack key columns into as few int64 words as needed.

    Each column is normalised to ``value - min + 1`` (0 is reserved for
    NULL, or the per-column top code when ``null_high``), opening a new
    word when 63 bits fill up.  Within a word the FIRST column takes the
    HIGHEST bits, so comparing the word list (word 0 primary) orders rows
    lexicographically ascending by (col 1, col 2, ...) -- grouping sorts
    therefore emit groups in key order, and a single- or multi-column
    sorted input stays sorted after packing (exec/ordering.py relies on
    both).  Rows beyond ``num_rows`` or excluded by ``mask`` get the
    global sentinel INT64_MAX in every word so they sort to the end.
    """
    widths = []
    for (lo, hi) in ranges:
        span = hi - lo + 2  # +1 for null slot, +1 so max value < 2**w
        widths.append(max(min(int(span).bit_length(), 63), 1))
    n = len(cols[0])
    device = cols[0].data.device
    # greedy first-fit grouping of columns into 63-bit words (in order)
    groups: List[List[int]] = [[]]
    used = 0
    for i, w in enumerate(widths):
        if used + w > 63:
            groups.append([])
            used = 0
        groups[-1].append(i)
        used += w
    words: List[torch.Tensor] = []
    for g in groups:
        word = torch.zeros((n,), dtype=torch.int64, device=device)
        shift = sum(widths[i] for i in g)
        for i in g:  # earlier column -> higher bits
            c, (lo, hi), w = cols[i], ranges[i], widths[i]
            shift -= w
            v = c.data.to(torch.int64) - lo + 1
            v = torch.clamp(v, 0, (1 << w) - 1)
            if c.validity is not None:
                nullcode = (hi - lo + 2) if null_high else 0
                v = torch.where(c.validity, v, nullcode)
            word = word | (v << shift)
        words.append(word)
    dead = _dead_rows(n, num_rows, mask, device)
    return [torch.where(dead, INT64_MAX, wd) for wd in words]


def pack_keys(
    cols: Sequence[Column],
    ranges: Sequence[Tuple[int, int]],
    num_rows,
    mask: Optional[torch.Tensor] = None,
    null_high: bool = False,
) -> torch.Tensor:
    """Single-word packing (joins); raises if the key exceeds 63 bits.
    TPC-H's widest join composite -- partsupp's (partkey, suppkey) -- fits
    at every published scale factor."""
    words = pack_key_words(cols, ranges, num_rows, mask, null_high)
    if len(words) != 1:
        raise NotImplementedError(
            "join key exceeds 63 bits; multi-word join keys TBD")
    return words[0]


_MIX64 = int(np.uint64(0x9E3779B97F4A7C15).astype(np.int64))
_MIX_MASK = (1 << 62) - 1


def mix_key_word(
    cols: Sequence[Column],
    ranges: Sequence[Tuple[int, int]],
    num_rows,
    mask: Optional[torch.Tensor] = None,
    null_high: bool = False,
) -> torch.Tensor:
    """Collision-prone 62-bit mix of wide composite keys (used when the
    exact packing exceeds 63 bits).  Callers MUST verify candidate matches
    against the real key columns.

    Dead/invalid rows get sentinels outside the live 62-bit range:
    INT64_MAX on the build side, -1 on the probe side -- they can never
    collide with live values or each other."""
    n = len(cols[0])
    device = cols[0].data.device
    word = torch.zeros((n,), dtype=torch.int64, device=device)
    invalid = torch.zeros((n,), dtype=torch.bool, device=device)
    for c, (lo, hi) in zip(cols, ranges):
        v = c.data.to(torch.int64) - lo + 1
        if c.validity is not None:
            invalid = invalid | ~c.validity
        word = (word * _MIX64) ^ v  # int64 multiply wraps
    word = word & _MIX_MASK
    dead = _dead_rows(n, num_rows, mask, device) | invalid
    return torch.where(dead, INT64_MAX if null_high else -1, word)


def iota(n: int, device="cuda") -> torch.Tensor:
    return torch.arange(n, dtype=torch.int64, device=device)


def sort_permutation(keys: Sequence[torch.Tensor]) -> torch.Tensor:
    """The stable row permutation (int64) that orders 1-D ``keys`` of one
    length lexicographically ascending, ``keys[0]`` most significant: one
    stable ``torch.sort`` per key, from the last to the first, each on the
    key as permuted so far.  int8 / bool keys (row liveness, boundary
    flags) sort like any other."""
    perm = None
    for key in reversed(list(keys)):
        if perm is None:
            perm = torch.sort(key, stable=True)[1]
        else:
            permuted = gather_rows([key.contiguous()], perm)[0]
            perm = gather_rows(
                [perm], torch.sort(permuted, stable=True)[1])[0]
    return perm


def sort_multi(operands: Sequence[torch.Tensor], num_keys: int
               ) -> Tuple[torch.Tensor, ...]:
    """Sort 1-D ``operands`` of one length together, lexicographically
    ascending over the first ``num_keys`` of them; the rest ride as payload
    (the semantics of ``jax.lax.sort`` with ``num_keys``).

    ``sort_permutation`` of the keys, then every operand moves through the
    permutation in ONE launch of the gather kernel, whatever their element
    widths.  The sort is always stable: a later pass must keep the order of
    the earlier ones, so ties keep their row order."""
    operands = list(operands)
    if not 1 <= num_keys <= len(operands):
        raise ValueError(f"num_keys {num_keys} of {len(operands)} operands")
    perm = sort_permutation(operands[:num_keys])
    return tuple(gather_rows([o.contiguous() for o in operands], perm))


def searchsorted_fast(a: torch.Tensor, v: torch.Tensor, side: str = "left"):
    """Insertion positions of ``v`` in the sorted ``a`` (int64)."""
    return torch.searchsorted(a.contiguous(), v.contiguous(),
                              right=(side == "right"))


def narrow_i32(words: torch.Tensor, bits: int) -> torch.Tensor:
    """Narrow packed int64 key words of known bit width to int32 (halves
    sort bytes).  INT64_MAX sentinels map onto INT32_MAX, preserving
    sort-to-the-end."""
    if bits > 30:
        return words
    return torch.clamp(words, max=np.iinfo(np.int32).max).to(torch.int32)
