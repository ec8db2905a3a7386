"""TPC-H as a data suite: the frozen generator's columns with the
connector metadata that the port's ``TpchCatalog`` declares for them
(primary keys, the physical sort order, the specification's statistics)."""

from __future__ import annotations

from .store import HostColumn
from .tpch_dbgen import TpchGenerator
from .tpch_schema import PRIMARY_KEYS, TABLES, column_stats as _stats


class Suite:
    def __init__(self, sf: float):
        self.sf = sf
        self.gen = TpchGenerator(sf)
        self.tables = {t: dict(cols) for t, cols in TABLES.items()}

    def num_rows(self, table: str) -> int:
        return self.gen.num_rows(table)

    def generate(self, table: str, column: str) -> HostColumn:
        t = self.tables[table][column]
        values = self.gen.column(table, column)
        if t.is_string:
            return HostColumn.strings(values, t)
        return HostColumn(values.astype(t.np_dtype, copy=False), t)

    def unique_keys(self, table: str):
        return [tuple(k) for k in PRIMARY_KEYS.get(table, [])]

    def sort_columns(self, table: str):
        # every table is emitted in the order of its primary key
        keys = PRIMARY_KEYS.get(table)
        return list(keys[0]) if keys else []

    def column_stats(self, table: str, column: str):
        """(ndv, lo, hi) in stored units, or None."""
        return _stats(column, self.sf)
