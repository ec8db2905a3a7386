"""TPC-DS as a data suite: the star schema that Q27, Q93 and Q98 read,
from the benchmark's own generator (``tpcds_dsgen.py``), with the
connector metadata that the port's ``TpcdsCatalog`` declares for these
columns (primary keys, no sort order, statistics from the row counts and
the sales window)."""

from __future__ import annotations

from .store import HostColumn
from .tpcds_dsgen import TpcdsGenerator
from .tpcds_schema import PRIMARY_KEYS, TABLES, column_stats as _stats


class Suite:
    def __init__(self, sf: float):
        self.sf = sf
        self.gen = TpcdsGenerator(sf)
        self.tables = {t: dict(cols) for t, cols in TABLES.items()}

    def num_rows(self, table: str) -> int:
        return self.gen.num_rows(table)

    def generate(self, table: str, column: str) -> HostColumn:
        t = self.tables[table][column]
        values, validity = self.gen.column(table, column)
        if t.is_string:
            return HostColumn.strings(values, t, validity)
        return HostColumn(values.astype(t.np_dtype, copy=False), t, validity)

    def unique_keys(self, table: str):
        return [tuple(k) for k in PRIMARY_KEYS.get(table, [])]

    def sort_columns(self, table: str):
        return []

    def column_stats(self, table: str, column: str):
        """(ndv, lo, hi) in stored units, or None."""
        return _stats(table, column, self.sf)
