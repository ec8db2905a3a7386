"""File-backed catalog: Parquet and CSV tables (lib/trino-parquet /
trino-hive file-format analog).

A directory becomes a catalog: every ``*.parquet`` / ``*.csv`` file is a
table named after its stem.  Columns materialise lazily per query (the
LazyBlock-at-scan design) and reach the catalog's device through
``Table.column``'s cache, mapped onto the engine's column model:

* integers -> bigint/integer, floats -> double, bools -> boolean
* decimal128 -> decimal(p,s) as exact scaled int64 (a value beyond int64
  raises ``OverflowError``)
* date32/timestamp -> date (int32 days)
* strings/binary -> sorted dictionary codes (int32 + host values)

CSV columns take the types pandas infers: no column is parsed as a date,
so an ISO date is VARCHAR, and ``12.34`` is DOUBLE.

Parquet goes through ``pyarrow``, imported inside each function that reads
or writes a file: without it a Parquet table raises ``ImportError`` and
nothing stands in for it.  CSV needs only pandas.  Writes go through
``write_parquet`` (ConnectorPageSink analog).
"""

from __future__ import annotations

import os
from typing import Dict, List, Optional

import numpy as np
import torch

from ..batch import Column, RecordBatch, encode_dictionary, to_device
from ..types import (
    BIGINT, BOOLEAN, DATE, DOUBLE, DecimalType, INTEGER, SqlType, VARCHAR,
)
from .catalog import Catalog, Table


def _pyarrow_parquet():
    try:
        import pyarrow.parquet as pq
    except ImportError as e:
        raise ImportError(
            "reading or writing Parquet needs pyarrow, which is not "
            "installed") from e
    return pq


def _sql_type(arrow_type) -> SqlType:
    import pyarrow as pa

    if pa.types.is_decimal(arrow_type):
        return DecimalType(arrow_type.precision, arrow_type.scale)
    if pa.types.is_boolean(arrow_type):
        return BOOLEAN
    if pa.types.is_int32(arrow_type) or pa.types.is_int16(arrow_type) \
            or pa.types.is_int8(arrow_type):
        return INTEGER
    if pa.types.is_integer(arrow_type):
        return BIGINT
    if pa.types.is_floating(arrow_type):
        return DOUBLE
    if pa.types.is_date(arrow_type) or pa.types.is_timestamp(arrow_type):
        return DATE
    return VARCHAR  # strings, binary, everything else via str()


def _unscaled_int64(arr, column: str, scale: int) -> np.ndarray:
    """A decimal128 / decimal256 column's unscaled values as int64, read
    from the two's-complement words of each chunk's value buffer; NULL rows
    hold 0.  A value that does not fit int64 raises ``OverflowError``."""
    out = []
    for chunk in arr.chunks:
        n = len(chunk)
        words = chunk.type.byte_width // 8
        buf = chunk.buffers()[1]
        w = np.frombuffer(buf, dtype="<i8",
                          count=(chunk.offset + n) * words)
        w = w.reshape(-1, words)[chunk.offset:]
        lo = w[:, 0]
        valid = np.ones(n, bool) if chunk.null_count == 0 \
            else ~np.asarray(chunk.is_null())
        # fits int64 iff every higher word is the sign of the lowest
        fits = np.all(w[:, 1:] == (lo >> 63)[:, None], axis=1)
        bad = np.flatnonzero(valid & ~fits)
        if len(bad):
            v = chunk[int(bad[0])].as_py()
            raise OverflowError(
                f"decimal value {v} does not fit int64 at "
                f"scale {scale} (column {column})")
        out.append(np.where(valid, lo, 0))
    return np.concatenate(out) if out else np.zeros(0, np.int64)


class ParquetTable(Table):
    def __init__(self, name: str, path: str,
                 row_groups: Optional[List[int]] = None, device="cuda"):
        pq = _pyarrow_parquet()

        self.path = path
        self._pf = pq.ParquetFile(path)
        schema = []
        arrow = self._pf.schema_arrow
        self._arrow_types = {}
        for field in arrow:
            t = _sql_type(field.type)
            schema.append((field.name, t))
            self._arrow_types[field.name] = field.type
        super().__init__(name, schema, device=device)
        self._row_groups = row_groups  # None = all (a pruned view sets it)
        self._pruned_views: Dict[object, Optional[Table]] = {}

    @property
    def num_rows(self) -> int:
        md = self._pf.metadata
        if self._row_groups is None:
            return md.num_rows
        return sum(md.row_group(g).num_rows for g in self._row_groups)

    def _stat_value(self, column: str, v):
        """Normalise a parquet statistics value to the engine's literal
        representation for that column (DATE -> epoch days int, decimal ->
        scaled int); None = not comparable (pruning skipped)."""
        import datetime
        import decimal as _dec

        t = self.schema[column]
        if v is None:
            return None
        if t.kind == "date":
            if isinstance(v, datetime.datetime):
                v = v.date()
            if isinstance(v, datetime.date):
                return (v - datetime.date(1970, 1, 1)).days
            return None
        if t.kind == "decimal":
            if isinstance(v, _dec.Decimal):
                return int(v.scaleb(t.scale).to_integral_value())
            return None
        if isinstance(v, bytes):
            try:
                return v.decode()
            except UnicodeDecodeError:
                return None
        if isinstance(v, (bool, int, float, str)):
            return v
        return None

    def column_stats(self, name: str):
        """min/max from parquet row-group statistics (free — already in
        the footer); NDV is not stored by parquet, so it stays unknown.
        Reference: lib/trino-parquet statistics + the hive connector's
        stats provider."""
        from ..sql.stats import ColStats

        md = self._pf.metadata
        cols = [md.schema.column(i).name for i in range(md.num_columns)]
        if name not in cols:
            return None
        ci = cols.index(name)
        lo = hi = None
        groups = (self._row_groups if self._row_groups is not None
                  else range(md.num_row_groups))
        for g in groups:
            st = md.row_group(g).column(ci).statistics
            if st is None or not st.has_min_max:
                return None
            glo = self._stat_value(name, st.min)
            ghi = self._stat_value(name, st.max)
            if glo is None or ghi is None or isinstance(glo, str):
                return None
            lo = glo if lo is None else min(lo, glo)
            hi = ghi if hi is None else max(hi, ghi)
        if lo is None:
            return None
        return ColStats(ndv=None, lo=float(lo), hi=float(hi))

    def pruned(self, domain) -> Optional[Table]:
        """Row-group pruning on parquet statistics (reference:
        parquet predicate pushdown, lib/trino-parquet PredicateUtils /
        TupleDomainParquetPredicate).  A view keeps the table's device and
        unique keys, and is made once per domain."""
        if domain is None:
            return None
        key = domain.fingerprint()
        if key in self._pruned_views:
            return self._pruned_views[key]
        md = self._pf.metadata
        cols = [md.schema.column(i).name for i in range(md.num_columns)]
        col_idx = {c: i for i, c in enumerate(cols)}
        relevant = [c for c in domain.domains if c in col_idx]
        keep: Optional[List[int]] = None
        if relevant and not domain.none:
            keep = []
            for g in range(md.num_row_groups):
                rg = md.row_group(g)
                ok = True
                for c in relevant:
                    st = rg.column(col_idx[c]).statistics
                    if st is None or not st.has_min_max:
                        continue
                    lo = self._stat_value(c, st.min)
                    hi = self._stat_value(c, st.max)
                    if lo is None or hi is None:
                        continue
                    nulls = bool(st.null_count) if st.null_count \
                        is not None else True
                    if not domain.get(c).may_match(lo, hi, nulls):
                        ok = False
                        break
                if ok:
                    keep.append(g)
            if len(keep) == md.num_row_groups:
                keep = None
        elif domain.none:
            keep = []
        view: Optional[Table] = None
        if keep is not None:
            view = ParquetTable(self.name, self.path, row_groups=keep,
                                device=self.device)
            view.unique_keys = self.unique_keys
        self._pruned_views[key] = view
        return view

    def _read(self, column: str):
        if self._row_groups is None:
            return self._pf.read([column]).column(column)
        if not self._row_groups:
            import pyarrow as pa

            return pa.chunked_array([], type=self._arrow_types[column])
        return self._pf.read_row_groups(
            self._row_groups, [column]).column(column)

    def host_column(self, column: str) -> Column:
        import pyarrow as pa
        import pyarrow.compute as pc

        t = self.schema[column]
        arr = self._read(column)
        validity = None
        if arr.null_count:
            validity = ~np.asarray(arr.is_null())
        if t.is_string:
            vals = arr.to_pandas().astype(str).to_numpy()
            if validity is not None:
                vals = np.where(validity, vals, "")
            dictionary, codes = encode_dictionary(np.asarray(vals, dtype="U"))
            return Column(codes, t, validity=validity, dictionary=dictionary)
        at = self._arrow_types[column]
        if t.kind == "decimal":
            # the unscaled integers as stored, at the column's own scale
            # (a float64 cast corrupts values beyond ~15-16 digits)
            data = _unscaled_int64(arr, column, t.scale)
        elif t.kind == "date":
            if pa.types.is_timestamp(at):
                arr = pc.cast(arr, pa.date32())
            # days since 1970-01-01; NULL rows hold 0 (that day)
            data = np.asarray(pc.fill_null(
                arr.cast(pa.int32()), 0)).astype(np.int32)
        else:
            data = arr.to_pandas()
            fill = False if t.kind == "boolean" else 0
            data = np.asarray(data.fillna(fill)).astype(t.np_dtype)
        return Column(data, t, validity=validity)

    def _load(self, column: str, device) -> Column:
        return _upload(self.host_column(column), device)


class CsvTable(Table):
    def __init__(self, name: str, path: str, device="cuda"):
        import pandas as pd

        self.path = path
        self._df = pd.read_csv(path)
        schema = []
        for col in self._df.columns:
            dt = self._df[col].dtype
            if pd.api.types.is_bool_dtype(dt):
                t = BOOLEAN
            elif pd.api.types.is_integer_dtype(dt):
                t = BIGINT
            elif pd.api.types.is_float_dtype(dt):
                t = DOUBLE
            elif pd.api.types.is_datetime64_any_dtype(dt):
                t = DATE
            else:
                t = VARCHAR
            schema.append((col, t))
        super().__init__(name, schema, device=device)

    @property
    def num_rows(self) -> int:
        return len(self._df)

    def host_column(self, column: str) -> Column:
        t = self.schema[column]
        s = self._df[column]
        validity = None
        if s.isna().any():
            validity = ~s.isna().to_numpy()
        if t.is_string:
            vals = s.fillna("").astype(str).to_numpy()
            dictionary, codes = encode_dictionary(np.asarray(vals, dtype="U"))
            return Column(codes, t, validity=validity, dictionary=dictionary)
        if t.kind == "date":
            data = s.fillna(np.datetime64("1970-01-01")).to_numpy().astype(
                "datetime64[D]").astype(np.int32)
        else:
            fill = False if t.kind == "boolean" else 0
            data = s.fillna(fill).to_numpy().astype(t.np_dtype)
        return Column(data, t, validity=validity)

    def _load(self, column: str, device) -> Column:
        return _upload(self.host_column(column), device)


def _upload(c: Column, device) -> Column:
    return Column(to_device(c.data, device), c.type,
                  validity=None if c.validity is None
                  else to_device(c.validity, device),
                  dictionary=c.dictionary)


class FileCatalog(Catalog):
    """Every *.parquet / *.csv under ``root`` is a table (stem = name),
    its columns placed on ``device``."""

    def __init__(self, root: str, device="cuda"):
        super().__init__()
        self.root = root
        self.device = torch.device(device)
        for fn in sorted(os.listdir(root)):
            path = os.path.join(root, fn)
            stem, ext = os.path.splitext(fn)
            if ext == ".parquet":
                self.tables[stem] = ParquetTable(stem, path,
                                                 device=self.device)
            elif ext == ".csv":
                self.tables[stem] = CsvTable(stem, path, device=self.device)


def write_parquet(batch: RecordBatch, path: str) -> int:
    """RecordBatch -> parquet file (ConnectorPageSink analog)."""
    pq = _pyarrow_parquet()
    import pyarrow as pa

    n = int(batch.num_rows)
    arrays, names = [], []
    for name, c in batch.columns.items():
        vals = c.decode(n)
        arrays.append(pa.array(list(vals)))
        names.append(name)
    pq.write_table(pa.table(arrays, names=names), path)
    return n
