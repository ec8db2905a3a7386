"""The reduction of a device trace to the traced window's numbers: busy
time as the union of device intervals, the wall from the host's spans,
kernels without copies, and idle gaps named by the host span that was open,
with the host's clock set onto the trace's by the lead spin kernels."""

import types

import pytest
import torch

from perfbench.harness import Trace

CUDA = torch.autograd.DeviceType.CUDA


def event(name, start_us, end_us, device=CUDA, annotation=False):
    return types.SimpleNamespace(
        name=name, device_type=device, is_user_annotation=annotation,
        time_range=types.SimpleNamespace(start=start_us, end=end_us))


class Prof:
    def __init__(self, events):
        self._events = events

    def events(self):
        return self._events


def test_busy_wall_kernels_and_named_gaps():
    # trace clock (us): spins end at 100; the host saw the synchronize
    # return at 1,000,000 ns, so host_ns = us * 1e3 + 900,000
    evs = [event("spin_kernel", 0, 50), event("spin_kernel", 50, 100),
           event("k1", 200, 300), event("k2", 250, 400),
           event("Memcpy DtoH", 400, 420), event("k3", 900, 1000),
           event("perfbench-like range", 150, 1200, annotation=True),
           event("cpu op", 0, 5000, device=torch.autograd.DeviceType.CPU)]
    spans = [(1_050_000, 1_320_000, "sql:q3"),
             (1_320_000, 1_500_000, "to_host:q3"),
             (1_500_000, 1_950_000, "sql:q7"),
             (1_950_000, 2_000_000, "to_host:q7")]
    tr = Trace(Prof(evs), 2, spans, sync_ns=1_000_000)
    assert tr.aligned
    assert tr.busy_s == pytest.approx((220 + 100) / 1e6)
    assert tr.window_s == pytest.approx(0.00095)
    assert tr.kernels == 3 and tr.device_events == 4
    assert tr.lead_ms == pytest.approx(0.05)
    names = dict((round(s * 1e6), n) for n, s in tr.idle_gaps)
    # 420-900 us is 1,320,000-1,800,000 ns: its middle is inside sql:q7;
    # 50-200 us before the first kernel, 1000-1100 us after the last
    assert names == {480: "sql:q7", 50: "sql:q3", 100: "to_host:q7"}
    assert [n for n, _ in tr.device_ops][:2] == ["k2", "k1"]


def test_without_the_spins_the_gaps_go_unnamed():
    evs = [event("k1", 200, 300), event("k3", 900, 1000)]
    spans = [(0, 10, "sql:q1"), (10, 20, "to_host:q1")]
    tr = Trace(Prof(evs), 1, spans, sync_ns=0)
    assert not tr.aligned and tr.lead_ms is None
    assert tr.idle_gaps == [("unaligned", pytest.approx(600e-6))]
