"""Small-scale fixtures shared by the benchmark's tests."""

import functools

from perfbench.data.store import Store
from perfbench.traffic import Traffic

SF = 0.01
# seeds of the parameter instances (a run's own instances come from its
# mix's ``instance_seed``; these draw three other sets)
SEEDS = (11, 2 ** 31 + 5, 987654321)
CELLS = ("tpch-sf1.join", "tpch-sf1.scan", "tpch-sf1.adhoc")
SUITE_OF = {"tpch-sf1": "tpch"}


@functools.lru_cache(maxsize=None)
def store(config: str) -> Store:
    return Store({"name": config, "suite": SUITE_OF[config],
                  "scale_factor": SF}, cache=None)


def mix(traffic: str) -> dict:
    import json
    import os

    here = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    with open(os.path.join(here, "mixes", traffic + ".json")) as f:
        return json.load(f)


def traffic(cell: str, seed: int) -> Traffic:
    """The cell's traffic with its instances drawn from ``seed`` (None:
    the mix's own instances, those a run sends)."""
    config, name = cell.split(".")
    return Traffic(mix(name), SUITE_OF[config], seed or 0,
                   instance_seed=seed)


def tables(config: str, module) -> dict:
    st = store(config)
    return {t: {c: st.column(t, c) for c in cols}
            for t, cols in module.COLUMNS.items()}
