"""Columnar data model: the device-side replacement for Trino Page/Block.

A :class:`Column` is a fixed-width device tensor plus an optional validity
mask; strings are dictionary-encoded (int32 codes into a host-side sorted
dictionary, so code order == string order and range predicates work directly
on codes).  A :class:`RecordBatch` is an ordered dict of columns with a
row count.

Reference parity notes:
* ``spi/Page.java:18`` (Block[] + positionCount)  -> RecordBatch
* ``spi/block/LongArrayBlock.java`` etc.          -> plain device tensors
* ``spi/block/DictionaryBlock.java``              -> Column.dictionary
* ``spi/block/LazyBlock.java``                    -> lazy column loading is
  handled one level up, in the table scan (exec/catalog.py), which only
  materialises referenced columns.

Operators whose output cardinality is data-dependent (filter, join) compute
into padded capacity buffers plus a device count, and the executor
re-bucketizes (`round_capacity`) between operators so a compiled query's
shapes are static after discovery.  ``num_rows`` is a Python int in eager
execution and may be a 0-d device tensor inside a compiled fragment; nothing
in this module forces it to the host.

Every constructor that places data takes an explicit ``device``
(default ``"cuda"``); nothing here looks for a GPU and carries on without.
"""

from __future__ import annotations

from dataclasses import dataclass, replace
from typing import Dict, Optional

import numpy as np
import torch

from .types import SqlType


def _host(t) -> np.ndarray:
    """Device tensor -> host numpy (the only readback in this module)."""
    return t.detach().cpu().numpy()


def to_device(arr: np.ndarray, device) -> torch.Tensor:
    """Host numpy array -> contiguous tensor on ``device``."""
    return torch.from_numpy(np.ascontiguousarray(arr)).to(device)


_TORCH_DTYPES = {
    np.dtype(np.int64): torch.int64, np.dtype(np.int32): torch.int32,
    np.dtype(np.int16): torch.int16, np.dtype(np.int8): torch.int8,
    np.dtype(np.float64): torch.float64, np.dtype(np.float32): torch.float32,
    np.dtype(np.bool_): torch.bool,
}


def torch_dtype(t: SqlType) -> torch.dtype:
    """The tensor dtype that stores values of SQL type ``t``."""
    return _TORCH_DTYPES[np.dtype(t.np_dtype)]


def _gather(sources, indices: torch.Tensor):
    """Every tensor of ``sources`` at ``indices`` along axis 0, clamped,
    through the gather kernel (``ops/kernels/gather.py``): one launch for
    all of them on a CUDA device."""
    # imported here: the ops package imports this module
    from .ops.kernels.gather import gather_rows

    if indices.dtype not in (torch.int32, torch.int64):
        indices = indices.to(torch.int64)
    return gather_rows([s.contiguous() for s in sources],
                       indices.contiguous())


def take_clamped(data: torch.Tensor, indices: torch.Tensor) -> torch.Tensor:
    """``data[indices]`` along axis 0 with out-of-range indices clamped to
    the ends (CUDA indexing does not clamp; the engine's padded index
    vectors rely on it)."""
    return _gather([data], indices)[0]


def round_capacity(n: int) -> int:
    """Bucket a row count to limit distinct compiled shapes.

    Powers of two above 1024, multiples of 128 below; minimum 128.
    """
    if n <= 128:
        return 128
    if n <= 1024:
        return ((n + 127) // 128) * 128
    p = 1
    while p < n:
        p <<= 1
    # allow 1.5x steps between powers of two to limit over-padding
    if p // 2 + p // 4 >= n and p > 2048:
        return p // 2 + p // 4
    return p


@dataclass
class Column:
    """One column: device data + optional validity + host dictionary."""

    data: torch.Tensor
    type: SqlType
    validity: Optional[torch.Tensor] = None  # bool, True = non-null
    dictionary: Optional[np.ndarray] = None  # sorted np array of str (varchar only)
    # nested types (array/map): data is a [n, W] padded element matrix,
    # lengths the per-row element count, map_values the aligned value
    # matrix for maps (the ArrayBlock/MapBlock analog with pad+length
    # instead of offsets -- static shapes)
    lengths: Optional[torch.Tensor] = None   # int32 [n]
    map_values: Optional[torch.Tensor] = None  # [n, W] (maps only)

    @property
    def is_nested(self) -> bool:
        return self.lengths is not None

    def __len__(self) -> int:
        return int(self.data.shape[0])

    def with_data(self, data, validity="keep") -> "Column":
        if isinstance(validity, str) and validity == "keep":
            validity = self.validity
        return replace(self, data=data, validity=validity)

    def gather(self, indices: torch.Tensor,
               valid: Optional[torch.Tensor] = None) -> "Column":
        """Column at ``indices`` (clamped); rows where ``valid`` is False
        become NULL."""
        return gather_columns({"c": self}, indices, valid)["c"]

    def decode(self, n: Optional[int] = None) -> np.ndarray:
        """Materialise to host numpy values (strings decoded, nulls -> object None)."""
        n = len(self) if n is None else n
        data = _host(self.data[:n])
        if self.lengths is not None:
            lens = _host(self.lengths[:n])

            def dec(vals, t):
                e = Column(torch.from_numpy(np.ascontiguousarray(vals)), t,
                           dictionary=self.dictionary)
                return e.decode(len(vals))

            out = np.empty(n, dtype=object)
            if self.type.kind == "map":
                vdata = _host(self.map_values[:n])
                for i in range(n):
                    k = dec(data[i, :lens[i]], self.type.key)
                    v = dec(vdata[i, :lens[i]], self.type.value)
                    out[i] = dict(zip(k.tolist(), v.tolist()))
            else:
                for i in range(n):
                    out[i] = dec(data[i, :lens[i]],
                                 self.type.element).tolist()
            if self.validity is not None:
                mask = _host(self.validity[:n])
                out[~mask] = None
            return out
        if self.type.is_string:
            assert self.dictionary is not None
            codes = np.clip(data, 0, len(self.dictionary) - 1) if len(self.dictionary) else data
            out = self.dictionary[codes] if len(self.dictionary) else np.array([""] * n, dtype=object)
            if self.type.kind == "varbinary":
                # physical latin-1 image -> real bytes at the boundary
                out = np.array([s.encode("latin-1") for s in out],
                               dtype=object)
        elif self.type.kind == "decimal":
            out = data / (10 ** self.type.scale)  # type: ignore[attr-defined]
        elif self.type.kind == "date":
            out = np.array(["1970-01-01"], dtype="datetime64[D]")[0] + data
        elif self.type.kind == "timestamp":
            out = (np.array(["1970-01-01"], dtype="datetime64[us]")[0]
                   + data.astype("timedelta64[us]"))
        elif self.type.kind == "timestamptz":
            # render the civil time in the column's zone + offset suffix
            off_min = self.type.offset_minutes
            local = (np.array(["1970-01-01"], dtype="datetime64[us]")[0]
                     + (data + self.type.offset_micros)
                     .astype("timedelta64[us]"))
            sign = "+" if off_min >= 0 else "-"
            suffix = f" {sign}{abs(off_min) // 60:02d}:{abs(off_min) % 60:02d}"
            out = np.array(
                [str(v).replace("T", " ") + suffix for v in local],
                dtype=object)
        elif self.type.kind == "interval_ds":
            # render like the reference's SqlIntervalDayTime: 'D HH:MM:SS.mmm'
            def _ds(us):
                sign = "-" if us < 0 else ""
                us = abs(int(us))
                d, rem = divmod(us, 86_400_000_000)
                h, rem = divmod(rem, 3_600_000_000)
                m, rem = divmod(rem, 60_000_000)
                s, rem = divmod(rem, 1_000_000)
                return f"{sign}{d} {h:02d}:{m:02d}:{s:02d}.{rem // 1000:03d}"

            out = np.array([_ds(v) for v in data], dtype=object)
        elif self.type.kind == "interval_ym":
            def _ym(months):
                sign = "-" if months < 0 else ""
                y, m = divmod(abs(int(months)), 12)
                return f"{sign}{y}-{m}"

            out = np.array([_ym(v) for v in data], dtype=object)
        else:
            out = data
        if self.validity is not None:
            mask = _host(self.validity[:n])
            out = np.asarray(out, dtype=object)
            out[~mask] = None
        return out


@dataclass
class RecordBatch:
    """An ordered set of equal-length columns with a row count."""

    columns: Dict[str, Column]
    num_rows: int

    @property
    def names(self):
        return list(self.columns.keys())

    def __getitem__(self, name: str) -> Column:
        return self.columns[name]

    def capacity(self) -> int:
        for c in self.columns.values():
            return len(c)
        return 0

    def select(self, names) -> "RecordBatch":
        return RecordBatch({n: self.columns[n] for n in names}, self.num_rows)

    def gather(self, indices: torch.Tensor, num_rows: int,
               valid: Optional[torch.Tensor] = None) -> "RecordBatch":
        return RecordBatch(gather_columns(self.columns, indices, valid),
                           num_rows)

    def to_pylist(self):
        cols = {n: c.decode(self.num_rows) for n, c in self.columns.items()}
        return [tuple(cols[n][i] for n in self.names) for i in range(self.num_rows)]

    def to_pandas(self):
        import pandas as pd

        return pd.DataFrame({n: c.decode(self.num_rows) for n, c in self.columns.items()})


def from_numpy(arrays: Dict[str, np.ndarray], types: Dict[str, SqlType],
               dictionaries: Optional[Dict[str, np.ndarray]] = None,
               device="cuda") -> RecordBatch:
    """Build a RecordBatch on ``device`` from host arrays (test/ingest
    helper)."""
    dictionaries = dictionaries or {}
    cols = {}
    n = None
    for name, arr in arrays.items():
        t = types[name]
        n = len(arr) if n is None else n
        if t.is_string and name not in dictionaries and arr.dtype.kind in ("U", "O", "S"):
            dictionary, codes = encode_dictionary(arr)
            cols[name] = Column(to_device(codes, device), t,
                                dictionary=dictionary)
        elif t.kind == "timestamp" and arr.dtype.kind == "M":
            micros = arr.astype("datetime64[us]").astype(np.int64)
            cols[name] = Column(to_device(micros, device), t)
        elif t.kind == "date" and arr.dtype.kind == "M":
            days = arr.astype("datetime64[D]").astype(np.int32)
            cols[name] = Column(to_device(days, device), t)
        else:
            cols[name] = Column(
                to_device(arr.astype(t.np_dtype, copy=False), device), t,
                dictionary=dictionaries.get(name),
            )
    return RecordBatch(cols, n or 0)


def hash_strings_host(strings) -> "np.ndarray":
    """Vectorized, width-independent uint64 hash of a numpy 'U' array.

    numpy 'U' storage is fixed-width UTF-32, so ``view(uint32)`` exposes a
    [n, W] codepoint matrix (W = longest entry, zero-padded).  The hash is
    a positional polynomial Σ cp[i]·M^(i+1) ⊕ len·C — padding codepoints
    are zero and contribute nothing, so two hosts with different local
    dictionary widths produce identical hashes for equal values.  Replaces
    a per-entry Python md5 loop (hostile at SF100 dictionary sizes)."""
    import numpy as np

    d = np.asarray(strings, dtype="U")
    nd = len(d)
    if nd == 0:
        return np.zeros(0, np.uint64)
    w = max(d.dtype.itemsize // 4, 1)
    cps = np.frombuffer(d.tobytes(), dtype=np.uint32).reshape(
        nd, w).astype(np.uint64)
    m = np.uint64(0x9E3779B97F4A7C15)
    with np.errstate(over="ignore"):
        powers = np.empty(w, np.uint64)
        acc = m
        for i in range(w):  # W is small (longest string), not dict size
            powers[i] = acc
            acc = acc * m
        h = (cps * powers[None, :]).sum(axis=1, dtype=np.uint64)
        lengths = (cps != 0).sum(axis=1).astype(np.uint64)
        h ^= lengths * np.uint64(0xFF51AFD7ED558CCD)
    return h



def encode_dictionary(values: np.ndarray):
    """Sort-dictionary-encode a host string array → (dictionary, int32 codes).

    The dictionary is sorted, so code comparisons implement string
    comparisons (reference DictionaryBlock gives no such ordering guarantee;
    we add it because every device-side string comparison rides on it).
    """
    dictionary, codes = np.unique(np.asarray(values), return_inverse=True)
    return dictionary, codes.astype(np.int32)


_PARTS = ("data", "validity", "lengths", "map_values")


def gather_columns(cols: Dict[str, Column], indices: torch.Tensor,
                   valid: Optional[torch.Tensor] = None) -> Dict[str, Column]:
    """Gather many columns at the same (clamped) indices: data, validity
    and nested parts of every column go through the gather kernel together,
    in one launch; rows where ``valid`` is False become NULL."""
    slots = [(name, part) for name, c in cols.items() for part in _PARTS
             if getattr(c, part) is not None]
    moved = dict(zip(slots, _gather(
        [getattr(cols[name], part) for name, part in slots], indices)))
    out: Dict[str, Column] = {}
    for name, c in cols.items():
        parts = {part: moved[(name, part)] for part in _PARTS
                 if (name, part) in moved}
        if valid is not None:
            v = parts.get("validity")
            parts["validity"] = valid if v is None else (v & valid)
        out[name] = replace(c, **parts)
    return out


def device_counts(counts, device) -> torch.Tensor:
    """Row counts (Python ints or 0-d device tensors) as one int64 tensor
    on ``device``, made without a host sync."""
    return torch.stack([
        c.reshape(()).to(torch.int64) if isinstance(c, torch.Tensor)
        else torch.full((), int(c), dtype=torch.int64, device=device)
        for c in counts])


def concat_batches(a: "RecordBatch", b: "RecordBatch",
                   capacity: int) -> "RecordBatch":
    """Concatenate two batches with identical column sets: the rows of
    ``b`` follow the live rows of ``a``.  Every part of every column moves
    in the dynamic-copy kernel (``ops/kernels/dyncopy.py``; one launch),
    with both row counts on the device.  Nested ``[n, W]``
    parts of different widths are padded with zeros to the wider; a
    validity mask only one side carries counts as all-valid on the other.
    Rows past the total are zeros (the JAX package repeats ``b``'s last
    row there; both are garbage by contract)."""
    from .ops.kernels.dyncopy import concat_rows

    device = next(iter(a.columns.values())).data.device
    columns, slots = [], []
    for name, ca in a.columns.items():
        cb = b.columns[name]
        for part in _PARTS:
            x, y = getattr(ca, part), getattr(cb, part)
            if x is None and y is None:
                continue
            columns.append([None if t is None else t.contiguous()
                            for t in (x, y)])
            slots.append((name, part))
    moved = dict(zip(slots, concat_rows(
        columns, device_counts([a.num_rows, b.num_rows], device),
        capacity)))
    cols = {}
    for name, ca in a.columns.items():
        parts = {part: moved.get((name, part)) for part in _PARTS}
        cols[name] = replace(ca, **parts)
    return RecordBatch(cols, a.num_rows + b.num_rows)
