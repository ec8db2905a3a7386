"""Formal connector SPI: split enumeration, page sources, page sinks.

The duck-typed ``exec/catalog.Table`` surface remains the data-model
contract (schema, lazy columns, stats, pruning); this module adds the
three interfaces the reference exposes to external connectors and the
engine previously kept implicit:

* **ConnectorSplitManager** (``spi/connector/ConnectorSplitManager.java``)
  — enumerate the units of parallel scan work for a table.  The engine's
  distributed scheduler asks the catalog's split manager instead of
  assuming uniform row-range shards; a connector can return fewer or
  unevenly-sized splits (file-per-split, bucket-per-split, ...).
* **ConnectorPageSource** (``spi/connector/ConnectorPageSource.java``) —
  stream a split's rows as RecordBatch pages.
* **ConnectorPageSink** (``spi/connector/ConnectorPageSink.java``) —
  write pages into a table with all-or-nothing visibility: rows become
  visible only at ``finish()`` (the TableFinishOperator contract —
  ``operator/TableFinishOperator.java``); ``abort()`` discards.

``Connector`` bundles the three with a metadata catalog.  Built-in
catalogs get defaults (``FixedCountSplitManager``, ``TablePageSource``);
``MemoryTable`` provides the writable reference implementation.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, Iterator, List, Optional

from ..batch import RecordBatch


@dataclass(frozen=True)
class ConnectorSplit:
    """One unit of scan parallelism (``spi/connector/ConnectorSplit``).

    ``index``/``count`` describe a row-range shard (the built-in
    partitioning); ``info`` carries connector-opaque addressing (file
    path, byte range, bucket id ...) — the engine never interprets it,
    it only ships it back to the connector's page source."""

    table: str
    index: int
    count: int
    info: Optional[dict] = None

    def to_wire(self) -> dict:
        d = {"index": self.index, "count": self.count}
        if self.info:
            d["info"] = self.info
        return d


class ConnectorSplitManager:
    """Split enumeration (``ConnectorSplitManager.getSplits``)."""

    def splits(self, table, desired: int) -> List[ConnectorSplit]:
        raise NotImplementedError


class FixedCountSplitManager(ConnectorSplitManager):
    """Default: ``desired`` uniform row-range shards — the built-in
    generator/memory connectors can start a scan at any row offset
    (the trino-tpch ``TpchSplitManager`` policy: nodes × splitsPerNode
    uniform splits)."""

    def splits(self, table, desired: int) -> List[ConnectorSplit]:
        n = max(int(desired), 1)
        return [ConnectorSplit(table.name, i, n) for i in range(n)]


def split_manager_for(catalog) -> ConnectorSplitManager:
    """The catalog's split manager (``split_manager`` attribute) or the
    uniform default."""
    return getattr(catalog, "split_manager", None) or \
        FixedCountSplitManager()


class ConnectorPageSource:
    """Pull-based page stream for one split."""

    def pages(self, columns: List[str],
              page_rows: int = 1 << 20) -> Iterator[RecordBatch]:
        raise NotImplementedError


class TablePageSource(ConnectorPageSource):
    """Default page source over any ``Table`` view: slices the (lazily
    materialised) columns into fixed-row pages."""

    def __init__(self, table):
        self.table = table

    def pages(self, columns: List[str],
              page_rows: int = 1 << 20) -> Iterator[RecordBatch]:
        from ..batch import Column

        n = self.table.num_rows
        batch = self.table.batch(columns)
        for lo in range(0, max(n, 1), page_rows):
            hi = min(lo + page_rows, n)
            if hi <= lo:
                break
            cols = {
                name: Column(
                    c.data[lo:hi], c.type,
                    validity=None if c.validity is None
                    else c.validity[lo:hi],
                    dictionary=c.dictionary)
                for name, c in batch.columns.items()
            }
            yield RecordBatch(cols, hi - lo)


class ConnectorPageSink:
    """Write-side half (``ConnectorPageSink``): pages accumulate
    invisibly until ``finish()`` commits them atomically."""

    def append(self, batch: RecordBatch) -> int:
        raise NotImplementedError

    def finish(self) -> int:
        raise NotImplementedError

    def abort(self) -> None:
        raise NotImplementedError


@dataclass
class Connector:
    """Bundle of the connector services for one catalog
    (``spi/connector/Connector.java``)."""

    catalog: object
    split_manager: ConnectorSplitManager = field(
        default_factory=FixedCountSplitManager)

    def page_source(self, split: ConnectorSplit) -> ConnectorPageSource:
        from ..exec.catalog import ShardedCatalog

        view = ShardedCatalog(self.catalog, split.index, split.count)
        return TablePageSource(view.table(split.table))

    def page_sink(self, table_name: str) -> ConnectorPageSink:
        table = self.catalog.table(table_name)
        sink = getattr(table, "page_sink", None)
        if sink is None:
            raise ValueError(f"table {table_name} is not writable")
        return sink()
