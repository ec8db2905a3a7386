"""Per-operator roofline report on a CUDA device (SURVEY §5.1).

For each hot operator, measures achieved throughput on the card and compares
it with the least time its bytes could take at the device-to-device copy
rate measured in the same process (every operator here is bandwidth-bound:
the engine has no dense-matmul stages).  No data-sheet number stands in for
the measured rate.

    python -m presto1_tpu_torch.testing.roofline [--rows 8388608] [--device cuda]

``query_bytes`` (the bytes a plan's scans read), ``device_ms`` (on-device
time a run from a ``torch.profiler`` trace) and ``copy_rate`` are the
pieces a benchmark reconciles its query times with.
"""

from __future__ import annotations

import argparse
import statistics
import subprocess
import time
from typing import Callable, Iterable, List, Tuple

import numpy as np
import torch

# bytes of the device-to-device copy the bandwidth bound is measured with
COPY_BYTES = 1 << 30
# spin kernels a trace starts with: the profiler has dropped the first
# device events of a session, and these absorb them (their rows are left out)
PROFILE_LEAD = 32


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def copy_rate(device="cuda", nbytes: int = COPY_BYTES) -> float:
    """GB/s of a ``copy_`` of ``nbytes`` within ``device``, counting the
    read and the write: the median of five CUDA-event timings of ten
    copies after two warm-up copies (on the CPU, the host clock)."""
    device = torch.device(device)
    src = torch.empty(nbytes, dtype=torch.uint8, device=device).random_(0, 255)
    dst = torch.empty_like(src)
    for _ in range(2):
        dst.copy_(src)
    _sync(device)
    reps, out = 10, []
    for _ in range(5):
        if device.type == "cuda":
            e0 = torch.cuda.Event(enable_timing=True)
            e1 = torch.cuda.Event(enable_timing=True)
            e0.record()
            for _ in range(reps):
                dst.copy_(src)
            e1.record()
            e1.synchronize()
            out.append(e0.elapsed_time(e1) / 1e3 / reps)
        else:
            t0 = time.perf_counter()
            for _ in range(reps):
                dst.copy_(src)
            out.append((time.perf_counter() - t0) / reps)
    return 2 * nbytes / statistics.median(out) / 1e9


def bench(fn, *args, reps=5, device="cuda"):
    """Seconds a call of ``fn(*args)``: one warm-up call, then ``reps``
    calls between two synchronisations of ``device``."""
    device = torch.device(device)
    fn(*args)
    _sync(device)
    t0 = time.perf_counter()
    for _ in range(reps):
        fn(*args)
    _sync(device)
    return (time.perf_counter() - t0) / reps


def query_bytes(plan, catalog) -> int:
    """Bytes the query must read from device memory: every scanned column
    at its device dtype (+ validity bytes).  The denominator for
    achieved-GB/s reporting (the reference treats
    input_megabytes_per_second as a first-class metric --
    ``AbstractOperatorBenchmark.java:310-329``)."""
    from ..sql.logical import Scan

    total = 0
    stack = [plan]
    while stack:
        node = stack.pop()
        if isinstance(node, Scan):
            t = catalog.table(node.table)
            n = t.num_rows
            for cname in node.symbols:
                col = t.column(cname)
                width = int(col.data.shape[1]) if col.data.dim() > 1 else 1
                total += n * col.data.element_size() * width
                if col.validity is not None:
                    total += n  # bool
        stack.extend(node.children)
    return total


def busy_time(intervals: Iterable[Tuple[float, float]]) -> float:
    """Length of the union of ``(start, end)`` intervals: nested and
    overlapping ones count once, the gaps between them not at all."""
    iv = sorted(intervals)
    if not iv:
        return 0.0
    busy = 0.0
    cur_lo, cur_hi = iv[0]
    for lo, hi in iv[1:]:
        if lo > cur_hi:
            busy += cur_hi - cur_lo
            cur_lo, cur_hi = lo, hi
        else:
            cur_hi = max(cur_hi, hi)
    return busy + (cur_hi - cur_lo)


def device_ms(run: Callable, reps: int = 10, device="cuda") -> float:
    """On-device ms a call of ``run``: ``reps`` calls traced by
    ``torch.profiler``, and the union of their device intervals (kernels,
    memsets, copies) divided by ``reps``.  Device events can overlap on
    several streams, so a sum would count them twice, and the card idles
    between enqueued calls, so a span would count the idle time.  Raises
    on anything but a CUDA device, and where the trace holds no device
    event: there is no host time in its place."""
    device = torch.device(device)
    if device.type != "cuda":
        raise ValueError(f"device_ms times a CUDA device, not {device}")
    if not torch.cuda.is_available():
        raise RuntimeError("device_ms: torch.cuda.is_available() is false")
    from torch.profiler import ProfilerActivity, profile

    run()
    torch.cuda.synchronize(device)
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(PROFILE_LEAD):
            torch.cuda._sleep(1)
        for _ in range(reps):
            run()
        torch.cuda.synchronize(device)
    iv = [(ev.time_range.start, ev.time_range.end) for ev in prof.events()
          if ev.device_type == torch.autograd.DeviceType.CUDA
          and "spin_kernel" not in ev.name]
    if not iv:
        raise RuntimeError("device_ms: the trace holds no device event")
    return busy_time(iv) / 1e3 / reps


def card() -> str:
    """``name, power limit`` of the first card, as nvidia-smi prints them."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=30).stdout
    return out.strip().splitlines()[0]


def main(argv=None) -> List[dict]:
    ap = argparse.ArgumentParser()
    ap.add_argument("--rows", type=int, default=1 << 23)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    n = args.rows
    dev = torch.device(args.device)

    from ..batch import Column
    from ..ops.common import sort_multi
    from ..ops.hashagg import AggSpec, group_aggregate
    from ..ops.kernels.filter_sum import range_filter_product_sum
    from ..ops.segments import compact_indices
    from ..types import BIGINT, DecimalType

    if dev.type == "cuda":
        nbytes, where = COPY_BYTES, card()
    else:
        # the host's own copy rate, at a size that keeps a small run small;
        # it bounds nothing on a card
        nbytes, where = max(1 << 20, 32 * n), f"{dev.type} (host memory)"
    rate = copy_rate(dev, nbytes)

    rng = np.random.RandomState(0)
    money = DecimalType(12, 2)

    def up(a):
        return torch.from_numpy(a).to(dev)

    key6 = up(rng.randint(0, 6, n).astype(np.int64))
    keyN = up(rng.randint(0, max(n // 4, 1), n).astype(np.int64))
    val = up(rng.randint(0, 10 ** 7, n).astype(np.int64))
    ship = up(rng.randint(8000, 10600, n).astype(np.int64))

    rows = []

    def report(name, wall, bytes_touched):
        bound = bytes_touched / (rate * 1e9)
        rows.append({"operator": name, "mrows_per_s": n / wall / 1e6,
                     "ms": wall * 1e3, "bytes": bytes_touched,
                     "bound_ms": bound * 1e3,
                     "pct_of_bound": 100.0 * bound / wall})

    # filter mask + masked sum (Q6 core): read 2 cols, no write
    report("filter+sum (torch)",
           bench(lambda s, v: torch.sum(torch.where(
               (s >= 8766) & (s < 9131), v, 0)), ship, val, device=dev),
           2 * n * 8)

    # the hand kernel over four int32 columns (a plain version on the CPU)
    ship32, disc32 = ship.to(torch.int32), (val % 11).to(torch.int32)
    qty32, price32 = (val % 50).to(torch.int32), val.to(torch.int32)
    bounds = torch.tensor([8766, 9131, 0, 10, 5000], dtype=torch.int64,
                          device=dev)
    report("filter+sum (filter_sum kernel)",
           bench(lambda: range_filter_product_sum(
               ship32, disc32, qty32, price32, bounds), device=dev),
           4 * n * 4)

    # group aggregate, 6 groups (Q1 shape): a dense key domain, so the
    # dense_group_agg kernel in one pass; it reads the key and the value
    # once (the reference's formula counts the reads and writes of its
    # sort, which the dense path does not make)
    def ga(k, v):
        return group_aggregate(
            [("k", Column(k, BIGINT))],
            [AggSpec("sum", Column(v, money), "s"),
             AggSpec("avg", Column(v, money), "a")],
            n, [(0, 5)], 128).columns["s"].data

    report("group agg 6 grp (dense)", bench(ga, key6, val, device=dev),
           2 * n * 8)

    # sort of a key with its row numbers (the aggregation's general path)
    iota = torch.arange(n, dtype=torch.int64, device=dev)
    report("sort 2 operands", bench(lambda k: sort_multi((k, iota), 1)[0],
                                    keyN, device=dev), 4 * n * 8)

    # join probe: searchsorted both sides
    bk = torch.sort(up(rng.randint(0, n, max(n // 4, 1)).astype(np.int64)))[0]
    report("join probe (searchsorted)",
           bench(torch.searchsorted, bk, keyN, device=dev),
           n * 8 * 10)  # ~log passes over probe + binary-search gathers

    # compaction (the compact kernel): it reads the bool mask and writes the
    # int64 row numbers into capacity n (the reference's formula counts
    # the three passes of its sort-based compaction)
    mask = ship < 9131
    report("compaction (compact kernel)",
           bench(lambda m: compact_indices(m, n)[0], mask, device=dev),
           n * 1 + n * 8)

    print(f"\nroofline @ {n} rows on {where}: copy rate {rate:.1f} GB/s "
          f"measured ({nbytes} bytes read + written)")
    print(f"{'operator':34s} {'Mrows/s':>9s} {'ms':>8s} {'bound ms':>9s} "
          f"{'% bound':>7s}")
    for r in rows:
        print(f"{r['operator']:34s} {r['mrows_per_s']:9.1f} {r['ms']:8.3f} "
              f"{r['bound_ms']:9.3f} {r['pct_of_bound']:6.1f}%")
    return rows


if __name__ == "__main__":
    main()
