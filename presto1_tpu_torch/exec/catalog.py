"""Catalog abstraction: named tables that materialise columns lazily.

The analog of the reference's connector SPI
(``spi/connector/ConnectorMetadata`` + ``ConnectorPageSource``): a Table
reports its schema and row count, and loads only the columns a query
references (the LazyBlock idea — ``spi/block/LazyBlock.java:431`` — moved
up to the scan).  Loaded columns are cached as device tensors, once per device.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from ..batch import Column, RecordBatch, encode_dictionary, to_device
from ..types import SqlType


class Table:
    def __init__(self, name: str, schema: List[Tuple[str, SqlType]],
                 device="cuda"):
        self.name = name
        self.schema = dict(schema)
        self.column_order = [c for c, _ in schema]
        # where columns are placed unless the caller of column() says else
        self.device = torch.device(device)
        self._cache: Dict[Tuple[str, torch.device], Column] = {}
        self._ranges: Dict[str, Tuple[int, int]] = {}
        # connector-reported statistics (reference: ConnectorMetadata
        # getTableStatistics / plugin statistics providers): column sets
        # guaranteed unique (primary keys), consumed by the optimizer's
        # build-side N:1 detection instead of any hardcoded table list
        self.unique_keys: List[Tuple[str, ...]] = []
        # physical sort order of the stored rows (lexicographic ascending,
        # no NULLs in these columns); consumed by the executor's
        # order-propagation (exec/ordering.py) to elide grouping/build
        # sorts — the connector analog of sorted-table properties
        # (reference: ConnectorTableProperties / local properties)
        self.sort_columns: List[str] = []

    @property
    def num_rows(self) -> int:
        raise NotImplementedError

    def _load(self, column: str, device) -> Column:
        raise NotImplementedError

    def column(self, name: str, device=None) -> Column:
        """The column as tensors on ``device`` (default: the table's),
        uploaded once and cached."""
        device = self.device if device is None else torch.device(device)
        key = (name, device)
        if key not in self._cache:
            self._cache[key] = self._load(name, device)
        return self._cache[key]

    def cached(self, name: str, device) -> Optional[Column]:
        """The column on ``device`` if it is already there, else None
        (never uploads)."""
        return self._cache.get((name, torch.device(device)))

    def host_column(self, name: str) -> Column:
        """Column backed by host (numpy) data.  Subclasses with a
        host-native loader override this to avoid a device->host
        readback."""
        c = self.column(name)
        return Column(
            c.data.cpu().numpy(), c.type,
            validity=None if c.validity is None
            else c.validity.cpu().numpy(),
            dictionary=c.dictionary)

    def batch(self, columns: Optional[List[str]] = None,
              device=None) -> RecordBatch:
        cols = columns if columns is not None else self.column_order
        return RecordBatch({c: self.column(c, device) for c in cols},
                           self.num_rows)

    def pruned(self, domain) -> Optional["Table"]:
        """A cheaper view of this table containing at least every row that
        can satisfy ``domain`` (a sql.domain.TupleDomain over column
        names), or None when this connector has no pruning story.  The
        reference analog is TupleDomain pushdown into
        ConnectorMetadata.applyFilter / parquet predicate pushdown."""
        return None

    def column_range(self, name: str) -> Tuple[int, int]:
        """Exact (min, max) of an integer-backed column (cached)."""
        if name not in self._ranges:
            data = np.asarray(self.host_column(name).data)
            self._ranges[name] = (int(data.min()), int(data.max()))
        return self._ranges[name]

    def column_stats(self, name: str):
        """Connector-reported ``sql.stats.ColStats`` for a column, or None
        when the connector has none (reference:
        ``ConnectorMetadata.getTableStatistics`` /
        ``spi/statistics/ColumnStatistics``).  Consumed by the optimizer's
        selectivity/join/aggregation derivation (``sql/stats.py``)."""
        return None


class Catalog:
    def __init__(self):
        self.tables: Dict[str, Table] = {}

    def table(self, name: str) -> Table:
        return self.tables[name]

    def __contains__(self, name: str) -> bool:
        return name in self.tables


class TpchTable(Table):
    def __init__(self, name: str, gen, cache_dir: Optional[str] = None,
                 device="cuda"):
        from ..tpch.schema import TABLES

        super().__init__(name, TABLES[name], device=device)
        from ..tpch.schema import PRIMARY_KEYS

        self.unique_keys = PRIMARY_KEYS.get(name, [])
        # dbgen emits every table ordered by its primary key (verified
        # at SF1: all 8 tables monotone in PK; the reference's generator
        # io.trino.tpch iterates row numbers the same way)
        if self.unique_keys:
            self.sort_columns = list(self.unique_keys[0])
        self.gen = gen
        self.cache_dir = cache_dir
        self._num_rows: Optional[int] = None

    @property
    def num_rows(self) -> int:
        if self._num_rows is None:
            self._num_rows = self.gen.num_rows(self.name)
        return self._num_rows

    def column_stats(self, name: str):
        """Analytic TPC-H column statistics (spec-derived, SF-scaled) —
        the ``plugin/trino-tpch/.../statistics/`` analog."""
        from ..sql.stats import ColStats
        from ..tpch.schema import column_stats as _cs

        t = _cs(name, self.gen.sf)
        if t is None:
            return None
        ndv, lo, hi = t
        return ColStats(ndv=ndv, lo=lo, hi=hi)

    def _cache_path(self, column: str) -> Optional[str]:
        if self.cache_dir is None:
            return None
        import os

        os.makedirs(self.cache_dir, exist_ok=True)
        return f"{self.cache_dir}/{self.name}.{column}"

    def _load(self, column: str, device) -> Column:
        c = self.host_column(column)
        return Column(to_device(c.data, device), c.type,
                      dictionary=c.dictionary)

    def host_column(self, column: str) -> Column:
        """Host-native load (disk cache or dbgen) — no device involved."""
        t = self.schema[column]
        base = self._cache_path(column)
        if base is not None:
            import os

            if os.path.exists(base + ".npy"):
                data = np.load(base + ".npy")
                dictionary = None
                if os.path.exists(base + ".dict.npy"):
                    dictionary = np.load(base + ".dict.npy",
                                         allow_pickle=True)
                return Column(data, t, dictionary=dictionary)
        col = self._generate(column)
        if base is not None:
            np.save(base + ".npy", np.asarray(col.data))
            if col.dictionary is not None:
                np.save(base + ".dict.npy",
                        np.asarray(col.dictionary, dtype=object),
                        allow_pickle=True)
        return col

    def _generate(self, column: str) -> Column:
        from ..tpch.schema import ENUM_VOCABS

        t = self.schema[column]
        if t.is_string:
            # native fast path: packed text extraction + C++ dict encoding
            packed = self.gen.text_packed(self.name, column)
            if packed is not None:
                from .. import native

                res = native.dict_encode_packed(*packed)
                if res is not None:
                    dictionary, codes = res
                    return Column(codes, t, dictionary=dictionary)
        values = self.gen.column(self.name, column)
        if t.is_string:
            vocab = ENUM_VOCABS.get((self.name, column))
            if vocab is not None:
                dictionary = np.array(vocab)
                codes = np.searchsorted(
                    dictionary, np.asarray(values, dtype=dictionary.dtype)
                ).astype(np.int32)
            else:
                dictionary, codes = encode_dictionary(
                    np.asarray(values, dtype="U"))
            return Column(codes, t, dictionary=dictionary)
        return Column(values.astype(t.np_dtype, copy=False), t)


class ShardedTable(Table):
    """A contiguous row-range view of a base table — the worker-side analog
    of the reference's splits (``TpchSplitManager.java:36-55`` assigns
    ``nodes × splitsPerNode`` slices of each TPC-H table)."""

    def __init__(self, base: Table, index: int, count: int):
        super().__init__(base.name, list(base.schema.items()),
                         device=base.device)
        self.base = base
        self.unique_keys = list(base.unique_keys)
        self.sort_columns = list(base.sort_columns)  # contiguous slice
        n = base.num_rows
        self.lo = n * index // count
        self.hi = n * (index + 1) // count

    @property
    def num_rows(self) -> int:
        return self.hi - self.lo

    def _load(self, column: str, device) -> Column:
        whole = self.base.cached(column, device)
        if whole is not None:  # the base column is resident: a view of it
            return Column(whole.data[self.lo:self.hi], whole.type,
                          validity=None if whole.validity is None
                          else whole.validity[self.lo:self.hi],
                          dictionary=whole.dictionary)
        c = self.host_column(column)
        return Column(to_device(c.data, device), c.type,
                      validity=None if c.validity is None
                      else to_device(c.validity, device),
                      dictionary=c.dictionary)

    def host_column(self, column: str) -> Column:
        """Host-side shard slice with no device round-trip: the full base
        column is never uploaded just to slice it."""
        c = self.base.host_column(column)
        return Column(
            np.asarray(c.data)[self.lo:self.hi], c.type,
            validity=None if c.validity is None
            else np.asarray(c.validity)[self.lo:self.hi],
            dictionary=c.dictionary)


class ShardedCatalog(Catalog):
    """Catalog view holding shard ``index`` of ``count`` for every table."""

    def __init__(self, base: Catalog, index: int, count: int):
        super().__init__()
        self.base = base
        for name, t in base.tables.items():
            self.tables[name] = ShardedTable(t, index, count)


class TpchCatalog(Catalog):
    """Schema name -> scale factor, as the reference's TpchMetadata:97."""

    SCHEMAS = {"tiny": 0.01, "sf1": 1.0, "sf10": 10.0, "sf100": 100.0}

    def __init__(self, schema: str = "tiny", sf: Optional[float] = None,
                 cache_dir: Optional[str] = None, device="cuda"):
        from ..tpch.dbgen import TpchGenerator
        from ..tpch.schema import TABLES
        import os

        super().__init__()
        self.device = torch.device(device)
        self.sf = sf if sf is not None else self.SCHEMAS[schema]
        if cache_dir is None:
            cache_dir = os.environ.get("P1_TPCH_CACHE")
        if cache_dir:
            cache_dir = f"{cache_dir}/sf{self.sf:g}"
        gen = TpchGenerator(self.sf)
        self.gen = gen
        for name in TABLES:
            self.tables[name] = TpchTable(name, gen, cache_dir,
                                          device=self.device)
