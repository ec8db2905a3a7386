"""The port's roofline harness (``presto1_tpu_torch/testing/roofline.py``) on
the CPU: ``query_bytes`` against the JAX package's over the 22 TPC-H plans
at SF 0.01, the interval union that ``device_ms`` reads a trace with, the
report run through the plain versions of the kernels, and ``device_ms``
refusing anything but a CUDA device.
"""

import pytest
import torch

from presto1_tpu.exec.catalog import TpchCatalog as JTpchCatalog
from presto1_tpu.exec.engine import Engine as JEngine
from presto1_tpu.testing import roofline as j_roofline
from presto1_tpu_torch.exec.catalog import TpchCatalog
from presto1_tpu_torch.exec.engine import Engine
from presto1_tpu_torch.testing import roofline
from presto1_tpu_torch.tpch.queries import QUERIES

torch.set_num_threads(1)


@pytest.fixture(scope="module")
def engines():
    return (JEngine(JTpchCatalog(sf=0.01)),
            Engine(TpchCatalog(sf=0.01, device="cpu"), device="cpu"))


@pytest.mark.parametrize("q", sorted(QUERIES))
def test_query_bytes_equal_the_reference(engines, q):
    """Every scanned column at its device dtype and width, plus a byte a
    row of validity: the same count in both packages."""
    je, te = engines
    want = j_roofline.query_bytes(je.plan(QUERIES[q]), je.catalog)
    got = roofline.query_bytes(te.plan(QUERIES[q]), te.catalog)
    assert got == want > 0


def _reference_union(iv):
    """The JAX package's merge loop (``device_ms``, over 'XLA Ops'
    events), as it is written there."""
    iv = sorted(iv)
    busy = 0
    cur_lo, cur_hi = iv[0]
    for lo, hi in iv[1:]:
        if lo > cur_hi:
            busy += cur_hi - cur_lo
            cur_lo, cur_hi = lo, hi
        else:
            cur_hi = max(cur_hi, hi)
    return busy + cur_hi - cur_lo


@pytest.mark.parametrize("case,iv,want", [
    ("overlapping", [(0, 10), (5, 15), (12, 20)], 20),
    ("nested", [(0, 100), (10, 20), (30, 40), (50, 100)], 100),
    ("disjoint", [(30, 35), (0, 10), (20, 25)], 20),
    ("mixed", [(0, 4), (2, 3), (6, 9), (8, 12), (20, 21), (12, 13)], 12),
])
def test_interval_union(case, iv, want):
    assert roofline.busy_time(iv) == _reference_union(iv) == want, case
    assert roofline.busy_time([]) == 0.0


def test_main_runs_six_rows_through_the_plain_versions():
    rows = roofline.main(["--rows", "4096", "--device", "cpu"])
    assert [r["operator"] for r in rows] == [
        "filter+sum (torch)", "filter+sum (filter_sum kernel)",
        "group agg 6 grp (dense)", "sort 2 operands",
        "join probe (searchsorted)", "compaction (compact kernel)"]
    for r in rows:
        assert r["ms"] > 0 and r["bytes"] > 0 and r["bound_ms"] > 0
        assert r["pct_of_bound"] == pytest.approx(
            100 * r["bound_ms"] / r["ms"])


def test_device_ms_raises_off_the_card():
    with pytest.raises(ValueError, match="CUDA"):
        roofline.device_ms(lambda: torch.ones(3), device="cpu")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="cuda"):
            roofline.device_ms(lambda: torch.ones(3))


def test_defaults_are_the_card():
    import inspect

    assert inspect.signature(roofline.device_ms).parameters[
        "device"].default == "cuda"
    assert inspect.signature(roofline.copy_rate).parameters[
        "device"].default == "cuda"
    assert roofline.COPY_BYTES >= 1 << 30
