"""Wide-decimal sums in the port: the cases of ``tests/test_decimal_sums.py``
retargeted to ``presto1_tpu_torch`` on the CPU at SF 0.001, each answer
held equal to the JAX package's (type, scale and unscaled value exact), and
the overflow refused by both.
"""

import numpy as np
import pytest
import torch

from presto1_tpu.exec.catalog import TpchCatalog as JTpchCatalog
from presto1_tpu.exec.engine import Engine as JEngine
from presto1_tpu_torch.exec.catalog import TpchCatalog
from presto1_tpu_torch.exec.engine import Engine

torch.set_num_threads(1)


@pytest.fixture(scope="module")
def engines():
    return (Engine(TpchCatalog(sf=0.001, device="cpu"), device="cpu"),
            JEngine(JTpchCatalog(sf=0.001)))


def both(engines, sql, column):
    """(the port's result batch, its column's unscaled values), the type and
    the values held equal to the JAX package's."""
    engine, reference = engines
    got, want = engine.sql(sql), reference.sql(sql)
    n = int(got.num_rows)
    assert n == int(want.num_rows)
    g, w = got[column], want[column]
    assert str(g.type) == str(w.type)
    data = g.data[:n].cpu().numpy()
    np.testing.assert_array_equal(data, np.asarray(w.data)[:n])
    return got, data


def test_wide_scale_sum_exact(engines):
    # 3 x (1e10 + 1e-6) at scale 6: the true sum 30000000000.000003 is NOT
    # representable in float64, so a DOUBLE fallback would lose the last
    # digit; the exact path keeps it
    out, data = both(engines,
                     "select sum(cast(10000000000 as decimal(38,6)) "
                     "         + cast(0.000001 as decimal(38,6))) s "
                     "from nation where n_nationkey < 3", "s")
    col = out["s"]
    assert col.type.kind == "decimal" and col.type.scale == 6
    assert int(data[0]) == 30_000_000_000_000_003  # unscaled, exact


def test_small_scale_sum_still_decimal(engines):
    out, data = both(engines, "select sum(cast(1.25 as decimal(10,2))) s "
                              "from nation where n_nationkey < 4", "s")
    assert out["s"].type.kind == "decimal"
    assert int(data[0]) == 500  # 4 * 1.25 at scale 2


def test_sum_overflow_raises(engines):
    # 25 x 1e18 unscaled wraps int64; must raise, not return garbage
    sql = "select sum(cast(100000000 as decimal(28,10))) s from nation"
    for engine in engines:
        with pytest.raises(ArithmeticError, match="overflow"):
            engine.sql(sql)


def test_group_by_wide_sum_exact(engines):
    out, data = both(engines,
                     "select n_regionkey, "
                     "sum(cast(10000000000 as decimal(38,6)) "
                     "  + cast(0.000001 as decimal(38,6))) s "
                     "from nation group by n_regionkey order by n_regionkey",
                     "s")
    counts = engines[0].sql(
        "select n_regionkey, count(*) c from nation "
        "group by n_regionkey order by n_regionkey").to_pandas()
    assert out["s"].type.scale == 6
    for i, c in enumerate(counts.c):
        assert int(data[i]) == c * 10_000_000_000_000_001
