"""The logical bytes each template must scan, by the benchmark's own
count: each referenced column once, 8 bytes a BIGINT, DECIMAL or DOUBLE,
4 an INTEGER or DATE, 1 a VARCHAR of at most 256 distinct values and 4 a
wider one (SF 0.01: lineitem 59,973 rows, orders 15,000, customer 1,500,
supplier 100, nation 25)."""

import pytest

from perfbench.metrics.scan_roofline_pct import template_bytes
from perfbench.traffic import template

from .helpers import store

LI, O, C, S, N = 59973, 15000, 1500, 100, 25
EXPECTED = {
    ("tpch", "q1"): (1 + 1 + 8 + 8 + 8 + 8 + 4) * LI,
    ("tpch", "q3"): (8 + 1) * C + (8 + 8 + 4 + 4) * O + (8 + 8 + 8 + 4) * LI,
    ("tpch", "q6"): (4 + 8 + 8 + 8) * LI,
    ("tpch", "q7"): 16 * S + (8 + 8 + 8 + 8 + 4) * LI + 16 * O + 16 * C
    + (8 + 1) * N,
}
CONFIG = {"tpch": "tpch-sf1"}


@pytest.mark.parametrize("suite,name", sorted(EXPECTED))
def test_template_bytes(suite, name):
    assert template_bytes(store(CONFIG[suite]), template(suite, name)) \
        == EXPECTED[(suite, name)]


def test_scan_roofline_reads_the_peak_of_the_card_it_ran_on():
    from perfbench.harness import Run
    from perfbench.metrics import scan_roofline_pct

    class Trace:
        busy_s, queries = 0.001, 2

    q6 = template("tpch", "q6")
    inst = type("I", (), {"module": q6})
    run = Run(trace=Trace, traced=[inst, inst], store=store("tpch-sf1"),
              device_kind="card", peaks={"card": {"hbm_bytes_per_s": 1e12}})
    assert scan_roofline_pct.read(run) == pytest.approx(
        100 * 2 * EXPECTED[("tpch", "q6")] / 1e9)
    run.device_kind = "another card"
    assert scan_roofline_pct.read(run) is None
