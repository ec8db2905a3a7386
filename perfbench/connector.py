"""The benchmark's catalog (``port_catalog.py``) as a connector that a
node's catalog properties name by its factory, so that every node of a
cluster (``server/config.py::build_catalog``) serves the columns the
reference reads:

    connector.name=perfbench.connector:create
    bench.config-file=<the configuration as the run has it, JSON>
    bench.cache-dir=<the column cache's directory>

Without ``bench.cache-dir`` each node generates its columns itself (the
generator is frozen: every node makes the same arrays).
"""

from __future__ import annotations

import json

from .data.store import Store
from .port_catalog import BenchCatalog


def create(props: dict, name: str, device) -> BenchCatalog:
    with open(props["bench.config-file"]) as f:
        config = json.load(f)
    return BenchCatalog(Store(config, cache=props.get("bench.cache-dir")),
                        device=device)
