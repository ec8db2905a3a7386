"""A whole run (on the CPU, SF 0.01, without the look for a card) with
the timed path broken underneath comes out not correct, for each fault a
cell can have: an answer altered where it is produced, an answer left
unchanged from the query before (a stale state), and half of the rows
left out of every scan.  The same run unbroken is correct."""

import pytest

from perfbench.harness import run

from .helpers import CELLS, SF


def _altered(monkeypatch):
    from presto1_tpu_torch.batch import RecordBatch

    plain = RecordBatch.to_pylist

    def to_pylist(self):
        rows = plain(self)
        if rows:
            first = list(rows[0])
            v = first[-1]
            first[-1] = v + "x" if isinstance(v, str) else (
                1 if v is None else v + 1)
            rows[0] = tuple(first)
        return rows

    monkeypatch.setattr(RecordBatch, "to_pylist", to_pylist)


def _stale(monkeypatch):
    from presto1_tpu_torch.exec.engine import Engine

    plain, last = Engine.sql, {}

    def sql(self, text, *a, **k):
        out = last.get("out")
        last["out"] = plain(self, text, *a, **k)
        return out if out is not None else last["out"]

    monkeypatch.setattr(Engine, "sql", sql)


def _half(monkeypatch):
    from perfbench.port_catalog import BenchTable

    plain_rows, plain_load = BenchTable.num_rows, BenchTable._load

    def num_rows(self):
        return max(plain_rows.fget(self) // 2, 1)

    def _load(self, name, device):
        c = plain_load(self, name, device)
        n = num_rows(self)
        return type(c)(c.data[:n], c.type,
                       validity=None if c.validity is None
                       else c.validity[:n], dictionary=c.dictionary)

    monkeypatch.setattr(BenchTable, "num_rows", property(num_rows))
    monkeypatch.setattr(BenchTable, "_load", _load)


FAULTS = {"none": None, "altered": _altered, "stale": _stale,
          "half_rows": _half}


@pytest.mark.parametrize("fault", list(FAULTS))
@pytest.mark.parametrize("cell", CELLS)
def test_a_broken_run_is_not_correct(cell, fault, monkeypatch):
    if FAULTS[fault] is not None:
        FAULTS[fault](monkeypatch)
    out = run(cell, 31337, 2.0, False, device="cpu",
              config_override={"scale_factor": SF}, data_cache=None)
    assert out["correct"] is (fault == "none"), out["checks"]
    assert list(out)[-1] == "checks"
    assert {"correct", "attempted", "failed", "metrics", "device"} <= set(out)
