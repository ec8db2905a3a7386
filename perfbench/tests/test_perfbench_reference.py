"""The plain reference against the port, on every template of every cell,
for the mix's own parameter instances and three other sets drawn from
three seeds: every instance's answer through ``Engine.sql`` and
``to_pylist`` in the cell's own session (compiled for the dashboard cells,
eager for the ad-hoc one), as the window drives it."""

import pytest

from perfbench.reference.common import judge

from .helpers import CELLS, SEEDS, store, tables, traffic

_ENGINES = {}


def engine(config: str, compiled: bool):
    from presto1_tpu_torch.exec.engine import Engine
    from presto1_tpu_torch.exec.session import Session

    from perfbench.port_catalog import BenchCatalog

    key = (config, compiled)
    if key not in _ENGINES:
        session = Session()
        session.set("compile_queries", compiled)
        _ENGINES[key] = Engine(BenchCatalog(store(config), device="cpu"),
                               session=session, device="cpu")
    return _ENGINES[key]


@pytest.mark.parametrize("seed", (None,) + SEEDS)
@pytest.mark.parametrize("cell", CELLS)
def test_reference_agrees_with_the_port(cell, seed):
    config = cell.split(".")[0]
    tr = traffic(cell, seed)
    eng = engine(config, tr.mix["session"]["compile_queries"])
    for name, module in tr.templates.items():
        ctx = module.prepare(tables(config, module))
        for inst in tr.by_template[name]:
            want = module.answer(ctx, inst.params)
            got = eng.sql(inst.text).to_pylist()
            ok, worst = judge(got, want, module.OUTPUT, module.ORDER_KEY,
                              module.LIMIT)
            assert ok, (inst.text, got[:3], want[:3])
            assert worst <= 1e-12, (inst.text, worst)
            assert len(got) > 0, inst.text
